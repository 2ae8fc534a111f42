// The streamed red-black pass as a 2.5-D z-march (rbgs_stream.cu's design
// note says what it computes and why it is shaped so), shared by the
// production kernels of rbgs_stream.cu and the sweep-cost variants of
// sweepcost.cu. The Variant parameter removes one mechanism of the pass at a
// time; rbgs_stream.cu instantiates only kFull, so the production kernel is
// this code with every variant branch compiled out.
//
// The variants (sweepcost.cu says how they map onto the JAX probe's,
// tools/exp_sweepcost.py:11-16). Each is deterministic: every cell of a
// half-sweep's colour reads only cells of the other colour or itself, so
// no thread reads a cell that another writes in the same half-sweep.
//   kFull   the production pass;
//   kNoSel  no domain-face splice: the ring holds zeros outside the domain,
//           planes -1 and D too, and a face cell reads them (zero ghost
//           faces);
//   kNoIota no per-update domain test: a face block updates its cells
//           outside the domain too (rhs 0 there), never read by a cell
//           inside it (the splices) and never stored, so the result is
//           kFull's;
//   kNoRoll no x/y neighbour reads: x+, x-, y+ and y- are the cell itself;
//   kNoZn   no z neighbour reads: z+ and z- are the cell itself;
//   kArith  no neighbour reads and no colours: every cell of the region,
//           both colours, u = (rhs + a*(6*u)) * (1/c) in each half-sweep,
//           with the loads and the store as they are.
//
// The march (kernels/linsolve_stream.py::march_pass is its NumPy
// emulation, step for step, which the CPU tests hold to the plain passes).
// A block owns kTx x kTy output cells in (x, y) (32 x 16 at nsw 1, 32 x 32
// at nsw 2) and kChunk = 32 output planes [zs, ze). Its ring planes are
// L x LY = (kTx + 2M) x (kTy + 2M) cells from (x0, y0) = (bx*kTx - M,
// by*kTy - M), M = 2*nsw, and its ring has R = 2*nsw + 3 slots: plane q
// and its rhs and keep live in slot (q - zlo) % R, zlo = max(zs - M, 0)
// (-1 when the ring holds ghost planes). March step j:
//   1. plane j+1's u, rhs (and keep) are read from global memory into
//      registers;
//   2. half-sweep h = 0 .. 2*nsw-1 updates the cells of its colour (red,
//      odd packed coordinate sum, for even h) on plane q = j-1-h, within
//      rows and columns [h+1, L-2-h] of the ring plane and planes
//      [zs - M + h + 1, ze + M - 2 - h] of the domain, then a barrier. Half
//      h on q reads the other colour on q-1, q, q+1: on q+1 half h-1 ran
//      earlier in this step, on q one step ago, on q-1 two steps ago, and
//      half h+1 reaches q-1 only after this half. So each read sees the
//      value after half h-1, as a sweep over the whole grid gives;
//   3. plane j+1 goes from the registers into its slot just before the
//      last half-sweep (no slot that step reads), so its loads overlap the
//      earlier halves;
//   4. plane j-M, which the last half-sweep has just finished, is stored
//      where it is an output plane.
// The trapezoid is paid only in x and y and at the two ends of the
// z-range: the march starts M planes under zs and runs M past ze, and
// those planes are recomputed by the neighbouring block. Updates made per
// update needed at nsw 2: 1.20 in (x, y), times (4*kChunk + 12) /
// (4*kChunk) = 1.09 in z; cells loaded per output cell (1.56 in (x, y))
// x (kChunk + 2M) / kChunk = 1.95, the halo's re-reads mostly from the L2.
// The tiles were chosen by measurement on the H100: at nsw 2, 32 x 32 ran
// the empty pass faster than 32 x 16 and the keep pass as fast; at nsw 1,
// 32 x 16 was the faster.
//
// Colour-split rows. Each ring plane keeps its cells of packed parity 0
// (black) and parity 1 (red) in two halves of LY x HW words, HW = L/2:
// cell (lx, row) of plane q sits in half (x0 + lx + y0 + row + q) & 1 at
// row*HW + lx/2 (x0 is even). A thread owns one fixed quad of a ring
// plane, cells lx = 4m .. 4m+3 of one row: the pairs k = 2m, 2m+1 of both
// halves, two cells of each colour. In a half-sweep it updates its two
// cells of that colour with 64-bit loads: the cells themselves, their y and
// z neighbours (the same k in the other half of rows row±1 and planes q±1),
// and their x neighbours (the other half at k + off - 1 .. k + off + 1,
// off the cell's lx & 1: one 64-bit and one 32-bit load). The lanes of a
// warp take consecutive quads, so a warp's loads are consecutive words: no
// bank conflict, where the 3-D tile kernel this replaces stepped 2 words a
// lane, and half the load instructions of a cell a thread.
//
// rhs and keep are staged once a plane, in the same layout, by the loads
// of step 1: rhs in both colours, keep of the black cells, and beside them
// the black cells' u*keep, which the red half reads for its neighbours
// (relax multiplies the whole field by keep after each sweep). The black
// half writes u and u*keep of each cell it updates. Out of the domain the
// ring holds zeros (or the padded field's ghosts, PADDED).
//
// Edge splices only where they can occur: a block whose ring plane lies
// inside the domain in x and y (most of them) runs a path with no domain
// test and no x/y splice (FACE false); the z faces are a uniform branch on
// the plane (gz 0 or D-1). A face block keeps the splice semantics: a
// neighbour outside the domain is sign*self (x+ an outflow copy, sign +1).
//
// The march loop is unrolled by R, so that plane j0 + d of the unrolled
// step d sits in slot d: every slot index is a constant and every
// shared-memory access an immediate offset from the thread's quad, with
// no ring arithmetic at run time (a separate ring of 2*nsw + 2 slots for
// rhs and keep, which would save a slot, and a ring indexed at run time
// both ran slower on the H100).
//
// Shared memory per block, R slots of colour halves of HS words (LY*HW
// rounded up to 32): u and rhs in both halves and, with keep, the black
// cells' keep and u*keep:
//   nsw = 1: 5 x 4 x 384 words = 30,720 B (keep 46,080), 192 threads
//   nsw = 2: 7 x 4 x 800 words = 89,600 B (keep 134,400), 416 threads
// so two blocks an SM at nsw 2 and one with keep; over the 48 KB a launch
// gets by default, so the launch raises the limit once per kernel and
// device (march_smem).
#pragma once

#include "common.cuh"

namespace {

enum Variant { kFull = 0, kNoSel, kNoIota, kNoRoll, kNoZn, kArith };

// a block's output tile and planes (kernels/linsolve_stream.py MARCH_TILE,
// MARCH_CHUNK)
constexpr int kTx = 32, kChunk = 32;
template <int NSW>
constexpr int kTy = NSW == 1 ? 16 : 32;
constexpr int kMaxDevices = 64;

template <int NSW>
struct March {
  static constexpr int M = 2 * NSW;                  // halo
  static constexpr int L = kTx + 2 * M, LY = kTy<NSW> + 2 * M;
  static constexpr int HW = L / 2;                   // one colour of a row
  static constexpr int HQ = HW / 2;                  // quads a row
  static constexpr int NQ = LY * HQ;                 // quads a plane
  static constexpr int HS = (LY * HW + 31) / 32 * 32;  // a colour half
  static constexpr int R = 2 * NSW + 3;              // ring slots
  static constexpr int THREADS = (NQ + 31) / 32 * 32;  // a quad a thread
  static_assert(kTx % 4 == 0 && M % 2 == 0 && HW % 2 == 0,
                "x0 even, rows of whole quads");
  static_assert(4 * 2 * NSW <= 32, "the update mask: 4 bits a half-sweep");
};

template <int NSW, bool KEEP>
constexpr int march_smem() {
  return March<NSW>::R * March<NSW>::HS * (KEEP ? 6 : 4) *
         static_cast<int>(sizeof(float));
}

struct PassArgs {
  const float* fin;
  const float* rhs;
  int rsz, rsy;
  const float* keep;
  int ksz, ksy;
  float* out;
  int D, H, W;
  float a, crec;
  int neg_mask;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
// (rhs + a*s) * (1/c), each operation rounded on its own
__device__ __forceinline__ float relax1(float b, float s, float a,
                                        float crec) {
  return __fmul_rn(__fadd_rn(b, __fmul_rn(a, s)), crec);
}

// One block's march. A thread owns one quad of its ring planes: row `row`,
// cells lx = 4*kq .. 4*kq + 3, i.e. the pairs f and f+1 of both colour
// halves (f = row*HW + 2*kq); in a half-sweep it updates the quad's two
// cells of that colour, lx0 + off and lx0 + off + 2, with 64-bit
// shared-memory loads and stores.
template <int NSW, bool KEEP, bool PADDED, int V, bool FACE>
struct Marcher {
  using G = March<NSW>;
  // the ring holds planes -1 and D (the padded field's ghosts, or zeros)
  static constexpr bool GHOSTS = PADDED || V == kNoSel;
  static constexpr bool SPLICE = !GHOSTS;

  const PassArgs& p;
  const int x0, y0;
  float* const u;    // [R][2][HS]
  float* const rh;   // [R][2][HS]
  float* const ub;   // [R][HS]: black cells' u*keep
  float* const kb;   // [R][HS]: black cells' keep
  bool active;       // the plane has this thread's quad
  int f, row, lx0, rpar;
  unsigned vm;       // bit 4h + 2*off + c: cell lx0 + off + 2c updated in h
  unsigned lm;       // bit c (4 + c): cell lx0 + c holds u (rhs, keep)
  int uo, ro, ko;    // the quad's offsets in a plane of fin, rhs, keep
  float pu[4], pr[4], pk[4];   // the plane in flight

  __device__ Marcher(const PassArgs& args, int x0_, int y0_, float* smem)
      : p(args), x0(x0_), y0(y0_), u(smem), rh(u + G::R * 2 * G::HS),
        ub(rh + G::R * 2 * G::HS), kb(ub + G::R * G::HS) {
    const int t = threadIdx.x;
    active = t < G::NQ;
    row = t / G::HQ;
    const int kq = t - row * G::HQ;
    f = row * G::HW + 2 * kq;
    lx0 = 4 * kq;
    const int gy = y0 + row, gx0 = x0 + lx0;
    rpar = gy & 1;
    auto in_dom = [&](int gx) {
      return gx >= 0 && gx < p.W && gy >= 0 && gy < p.H;
    };
    vm = 0;
#pragma unroll
    for (int h = 0; h < 2 * NSW; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {   // b = 2*off + c
        const int lx = lx0 + (b >> 1) + 2 * (b & 1);
        const bool ok = active && row >= h + 1 && row <= G::LY - 2 - h &&
                        lx >= h + 1 && lx <= G::L - 2 - h &&
                        (!FACE || V == kNoIota || in_dom(x0 + lx));
        vm |= static_cast<unsigned>(ok) << (4 * h + b);
      }
    lm = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gx = gx0 + c;
      const bool g = PADDED ? gx >= -1 && gx <= p.W && gy >= -1 && gy <= p.H
                            : in_dom(gx);
      lm |= (static_cast<unsigned>(g) << c) |
            (static_cast<unsigned>(in_dom(gx)) << (4 + c));
    }
    uo = PADDED ? (gy + 1) * (p.W + 2) + gx0 + 1 : gy * p.W + gx0;
    ro = gy * p.rsy + gx0;
    ko = gy * p.ksy + gx0;
  }

  __device__ static constexpr int ring(int s) {
    return s >= G::R ? s - G::R : (s < 0 ? s + G::R : s);
  }

  // step 1: plane q's quad into registers; zeros where the ring holds
  // nothing of the field
  __device__ void read(int q) {
    const bool qin = q >= 0 && q < p.D;
    const bool qg = PADDED ? q >= -1 && q <= p.D : qin;
    const float* fu =
        p.fin + uo +
        (PADDED ? static_cast<long>(q + 1) * (p.H + 2) * (p.W + 2)
                : static_cast<long>(q) * p.H * p.W);
    const float* fr = p.rhs + ro + static_cast<long>(q) * p.rsz;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool gu = active && qg && (!FACE || (lm >> c) & 1);
      const bool gr = active && qin && (!FACE || (lm >> (4 + c)) & 1);
      pu[c] = gu ? __ldg(fu + c) : 0.0f;
      pr[c] = gr ? __ldg(fr + c) : 0.0f;
      if constexpr (KEEP)
        pk[c] = gr ? __ldg(p.keep + ko + static_cast<long>(q) * p.ksz + c)
                   : 0.0f;
    }
  }

  // step 3: the registers into slot s as colour halves: the even cells
  // (parity e) at f, f+1 of half e, the odd ones in half e^1
  __device__ void write(int s, int q) {
    if (!active) return;
    const int e = (rpar ^ q) & 1;
    float* us = u + s * 2 * G::HS + f;
    float* rs = rh + s * 2 * G::HS + f;
    st2(us + e * G::HS, pu[0], pu[2]);
    st2(us + (e ^ 1) * G::HS, pu[1], pu[3]);
    st2(rs + e * G::HS, pr[0], pr[2]);
    st2(rs + (e ^ 1) * G::HS, pr[1], pr[3]);
    if (KEEP) {   // the black cells (parity 0)
      const float k0 = e ? pk[1] : pk[0], k1 = e ? pk[3] : pk[2];
      st2(kb + s * G::HS + f, k0, k1);
      st2(ub + s * G::HS + f, __fmul_rn(e ? pu[1] : pu[0], k0),
          __fmul_rn(e ? pu[3] : pu[2], k1));
    }
  }

  // the other colour's words of slot t at this thread's pairs, as the
  // half-sweep of colour `col` reads them: the red half reads black cells
  // post-keep
  __device__ const float* other(int t, int col) const {
    if (KEEP && col == 1) return ub + t * G::HS + f;
    return u + (t * 2 + (col ^ 1)) * G::HS + f;
  }

  // the cells `bits` (1: the first, 2: the second) of the pair at `me`
  __device__ static void put(float* me, unsigned bits, float x, float y) {
    if (bits == 3)
      st2(me, x, y);
    else if (bits == 1)
      me[0] = x;
    else if (bits == 2)
      me[1] = y;
  }

  // step 2, kArith: both colours, no neighbour
  __device__ void arith(int h, int q, int s) {
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const int off = (col ^ rpar ^ q) & 1;
      const unsigned bits = (vm >> (4 * h + 2 * off)) & 3;
      if (!bits) continue;
      float* me = u + (s * 2 + col) * G::HS + f;
      const float2 v = ld2(me), b = ld2(rh + (s * 2 + col) * G::HS + f);
      put(me, bits, relax1(b.x, __fmul_rn(6.0f, v.x), p.a, p.crec),
          relax1(b.y, __fmul_rn(6.0f, v.y), p.a, p.crec));
    }
  }

  // step 2: half-sweep h on plane q in slot s (sp, sm: planes q+1, q-1)
  __device__ void half(int h, int q, int s, int sp, int sm) {
    if constexpr (V == kArith) {
      arith(h, q, s);
      return;
    }
    const int col = (h & 1) ^ 1;   // red (1) for even h
    const int off = (col ^ rpar ^ q) & 1;
    const unsigned bits = (vm >> (4 * h + 2 * off)) & 3;
    if (!bits) return;
    float* me = u + (s * 2 + col) * G::HS + f;
    const float* o = other(s, col);
    // x: the other colour at k+off-1, k+off (cell A) and k+off, k+off+1 (B)
    const float2 v = ld2(o);
    const float e3 = o[off ? 2 : -1];
    float xpa = off ? v.y : v.x, xma = off ? v.x : e3;
    float xpb = off ? e3 : v.y, xmb = off ? v.y : v.x;
    float2 yp = ld2(o + G::HW), ym = ld2(o - G::HW);
    float2 zp = ld2(other(sp, col)), zm = ld2(other(sm, col));
    const bool zf = SPLICE && (q == 0 || q == p.D - 1);
    float2 self = make_float2(0.0f, 0.0f);
    if ((SPLICE && (FACE || zf)) || V == kNoRoll || V == kNoZn)
      self = ld2(me);
    if (SPLICE && FACE) {
      const float sx = fst::face_sign(p.neg_mask, 0, 0);
      const float sy = fst::face_sign(p.neg_mask, 0, 1);
      const int gxa = x0 + lx0 + off, gy = y0 + row;
      if (gxa == p.W - 1) xpa = self.x;
      if (gxa + 2 == p.W - 1) xpb = self.y;
      if (gxa == 0) xma = __fmul_rn(sx, self.x);
      if (gxa + 2 == 0) xmb = __fmul_rn(sx, self.y);
      if (gy == p.H - 1) yp = make_float2(__fmul_rn(sy, self.x),
                                          __fmul_rn(sy, self.y));
      if (gy == 0) ym = make_float2(__fmul_rn(sy, self.x),
                                    __fmul_rn(sy, self.y));
    }
    if (zf) {
      const float sz = fst::face_sign(p.neg_mask, 0, 2);
      const float2 ss = make_float2(__fmul_rn(sz, self.x),
                                    __fmul_rn(sz, self.y));
      if (q == p.D - 1) zp = ss;
      if (q == 0) zm = ss;
    }
    if (V == kNoRoll) {
      xpa = xma = self.x;
      xpb = xmb = self.y;
      yp = ym = self;
    }
    if (V == kNoZn) zp = zm = self;
    float ta = __fadd_rn(xpa, xma), tb = __fadd_rn(xpb, xmb);
    ta = __fadd_rn(ta, yp.x);
    tb = __fadd_rn(tb, yp.y);
    ta = __fadd_rn(ta, ym.x);
    tb = __fadd_rn(tb, ym.y);
    ta = __fadd_rn(ta, zp.x);
    tb = __fadd_rn(tb, zp.y);
    ta = __fadd_rn(ta, zm.x);
    tb = __fadd_rn(tb, zm.y);
    const float2 b = ld2(rh + (s * 2 + col) * G::HS + f);
    const float va = relax1(b.x, ta, p.a, p.crec);
    const float vb = relax1(b.y, tb, p.a, p.crec);
    put(me, bits, va, vb);
    if (KEEP && col == 0) {
      const float2 k = ld2(kb + s * G::HS + f);
      put(ub + s * G::HS + f, bits, __fmul_rn(va, k.x), __fmul_rn(vb, k.y));
    }
  }

  // step 4: output plane q from slot s, a quad a thread
  __device__ void store(int q, int s) const {
    constexpr int QX = kTx / 4;
    const int t = threadIdx.x;
    if (t >= QX * kTy<NSW>) return;
    const int oy = t / QX, m = t - oy * QX;
    const int r = oy + G::M, gy = y0 + r;
    const int gx = x0 + G::M + 4 * m;
    if (gy >= p.H || gx >= p.W) return;
    const int fo = r * G::HW + G::M / 2 + 2 * m;
    const int e = (y0 + r + q) & 1;   // parity of the quad's even cells
    const float* ev = u + (s * 2 + e) * G::HS + fo;
    const float* od = u + (s * 2 + (e ^ 1)) * G::HS + fo;
    const float4 v = make_float4(ev[0], od[0], ev[1], od[1]);
    float* o = p.out + (static_cast<long>(q) * p.H + gy) * p.W + gx;
    if (gx + 3 < p.W && !(reinterpret_cast<unsigned long>(o) & 15)) {
      *reinterpret_cast<float4*>(o) = v;
      return;
    }
    o[0] = v.x;
    if (gx + 1 < p.W) o[1] = v.y;
    if (gx + 2 < p.W) o[2] = v.z;
    if (gx + 3 < p.W) o[3] = v.w;
  }

  __device__ void run() {
    constexpr int M = G::M;
    const int zs = blockIdx.z * kChunk, ze = min(zs + kChunk, p.D);
    const int zlo = max(zs - M, GHOSTS ? -1 : 0);
    const int zhi = min(ze + M - 1, GHOSTS ? p.D : p.D - 1);
    const int zend = ze - 1 + M;
    read(zlo);
    write(0, zlo);
    __syncthreads();
    // unrolled by R: plane j0 + d is in slot d, so every slot is a
    // constant and every shared-memory address an offset from the quad's
    for (int j0 = zlo; j0 <= zend; j0 += G::R) {
#pragma unroll
      for (int d = 0; d < G::R; ++d) {
        const int j = j0 + d;
        if (j > zend) break;
        const bool more = j + 1 <= zhi;
        if (more) read(j + 1);
#pragma unroll
        for (int h = 0; h < 2 * NSW; ++h) {
          if (h == 2 * NSW - 1 && more) write(ring(d + 1), j + 1);
          const int q = j - 1 - h;
          if (q >= max(zs - M + h + 1, 0) &&
              q <= min(ze + M - 2 - h, p.D - 1))
            half(h, q, ring(d - 1 - h), ring(d - h), ring(d - 2 - h));
          __syncthreads();
        }
        if (j - M >= zs) store(j - M, ring(d - M));
      }
    }
  }
};

// PADDED: fin is the padded (D+2, H+2, W+2) field (sweep 1: its ghost cells
// are loaded and read, never spliced). Otherwise fin is the packed pre-keep
// carry. rhs and keep are interior (D, H, W) views with z/y strides and x
// stride 1; out is packed.
template <int NSW, bool KEEP, bool PADDED, int V = kFull>
__global__ void __launch_bounds__(March<NSW>::THREADS)
    rbgs_march_kernel(const PassArgs args) {
  static_assert(V == kFull || (!KEEP && !PADDED),
                "the variants exist for the empty-scene pass only");
  using G = March<NSW>;
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * kTx - G::M;
  const int y0 = blockIdx.y * kTy<NSW> - G::M;
  if (x0 < 0 || y0 < 0 || x0 + G::L > args.W || y0 + G::LY > args.H)
    Marcher<NSW, KEEP, PADDED, V, true>(args, x0, y0, smem).run();
  else
    Marcher<NSW, KEEP, PADDED, V, false>(args, x0, y0, smem).run();
}

template <int NSW, bool KEEP, bool PADDED, int V = kFull>
int launch_march(const void* fin, const void* rhs, int rsz, int rsy,
                 const void* keep, int ksz, int ksy, void* out, int D, int H,
                 int W, float a, float crec, int neg_mask, void* stream) {
  const auto kernel = rbgs_march_kernel<NSW, KEEP, PADDED, V>;
  constexpr int smem = march_smem<NSW, KEEP>();
  // the dynamic shared-memory limit, raised once per kernel and device
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) done[dev] = true;
  }
  const PassArgs args{static_cast<const float*>(fin),
                      static_cast<const float*>(rhs), rsz, rsy,
                      static_cast<const float*>(keep), ksz, ksy,
                      static_cast<float*>(out), D, H, W, a, crec, neg_mask};
  const dim3 grid(fst::cdiv(W, kTx), fst::cdiv(H, kTy<NSW>),
                  fst::cdiv(D, kChunk));
  kernel<<<grid, March<NSW>::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return fst::launch_status();
}

}  // namespace
