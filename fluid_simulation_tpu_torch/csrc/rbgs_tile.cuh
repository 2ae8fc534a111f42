// The streamed red-black pass as a 2.5-D z-march (rbgs_stream.cu's design
// note says what it computes and why it is shaped so), shared by the
// production kernels of rbgs_stream.cu and the sweep-cost variants of
// sweepcost.cu. The Variant parameter removes one mechanism of the pass at a
// time; rbgs_stream.cu instantiates only kFull, so the production kernel is
// this code with every variant branch compiled out (the keep kernels also
// run kCoalesced's Marcher in their keep-free blocks, below).
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
//           with the loads and the store as they are;
//   kCoalesced  nothing removed: the keep forms' plane loads (fetch, land)
//           in the empty pass, kFull's function; the keep kernels' keep-free
//           blocks run it.
//
// The march (kernels/linsolve_stream.py::march_pass is its NumPy
// emulation, step for step, which the CPU tests hold to the plain passes).
// A block owns kTx x kTy output cells in (x, y) (32 x 16 at nsw 1, 32 x 32
// at nsw 2) and kChunk = 32 output planes [zs, ze). Its ring planes are
// L x LY = (kTx + 2M) x (kTy + 2M) cells from (x0, y0) = (bx*kTx - M,
// by*kTy - M), M = 2*nsw, and its ring has R = 2*nsw + 3 slots: plane q
// and its rhs and keep live in slot (q - zlo) % R, zlo = max(zs - M, 0)
// (-1 when the ring holds ghost planes). March step j:
//   1. plane j+1's u and rhs (and keep) start from global memory: into
//      registers, a quad a thread (read), or, in the keep forms, straight
//      into its slot by cp.async, coalesced (fetch);
//   2. half-sweep h = 0 .. 2*nsw-1 updates the cells of its colour (red,
//      odd packed coordinate sum, for even h) on plane q = j-1-h, within
//      rows and columns [h+1, L-2-h] of the ring plane and planes
//      [zs - M + h + 1, ze + M - 2 - h] of the domain, then a barrier. Half
//      h on q reads the other colour on q-1, q, q+1: on q+1 half h-1 ran
//      earlier in this step, on q one step ago, on q-1 two steps ago, and
//      half h+1 reaches q-1 only after this half. So each read sees the
//      value after half h-1, as a sweep over the whole grid gives;
//   3. plane j+1 goes from the registers into its slot just before the
//      last half-sweep (write), or the keep forms wait for their copies
//      just after it and turn its keep into bits (land, landed); its slot
//      is no slot that step reads, so the loads overlap the halves;
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
// rhs and keep are staged once a plane by the loads of step 1: rhs in both
// colours, in the same layout, and the keep of the black cells as bits
// (kb: a warp's ballot of its 32 copies a word, keep != 0), which the red
// half needs because it reads its black neighbours post-keep (relax
// multiplies the whole field by keep after each sweep). The ring holds u
// pre-keep only, and a barrier a step (landed, __syncthreads_or) marks the
// slots whose plane has a black cell in the domain with a keep other than
// 1: where none of the red half's three planes is marked, as in most
// blocks, the red half reads u as the empty form does; where one is, it
// multiplies each black neighbour by its bit ? 1 : 0, which is the keep
// itself because every caller's keep is 0 or 1 (scene/masks.py builds
// keep_scalar, keep_vel and fluid_i so). The black half reads its red
// neighbours pre-keep, as relax does, and needs no keep. Out of the domain
// the ring holds zeros (or the padded field's ghosts, PADDED).
//
// Keep-free blocks. Most blocks of a keep pass load no cell whose keep is
// not 1, so no plane of theirs is ever marked and the keep form computes
// exactly the empty form's values there. A table of one byte a block
// (PassArgs::table, built once a mask by rbgs_stream.cu's march_table
// kernel) says whether any cell of the block's footprint, the ring planes'
// L x LY cells of every plane it loads, [zlo, zhi], has a keep other than
// 1; march_block reads its byte once at entry, and a block whose byte is 0
// runs the keep-free Marcher on the keep forms' coalesced loads
// (kCoalesced: no keep copy, no ballot, no __syncthreads_or), bit for bit
// the keep form's, since a keep of 1 multiplies exactly. The march loop
// itself has no branch on it.
//
// Plane loads. A quad a thread (read) puts a warp's lanes 16 B apart, so
// each of its four loads of an operand spans ~20 sectors of several rows
// and uses a quarter of each: the four find the rest only in the L1. The
// keep forms (COAL) copy cells t + i*NQ, i = 0..3, of the plane in
// row-major order instead (a plane is 4*NQ cells, NQ = RS*L whole rows),
// so a warp's copy is 32 consecutive words of one row or two, a thread's
// four copies one column RS rows apart (one address and one stride an
// operand), and cp.async puts each in its half's word c / 2 with no
// register held for it; lanes 2i and 2i+1 write one word of the two
// halves, which HP = HS + 16 puts 16 banks apart. Wider copies do not
// apply: cells of one colour are not adjacent in global memory, and the
// rhs and keep views are only 4-byte aligned (TMA neither: their rows are
// (W+2)*4 bytes apart, no multiple of 16).
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
// rounded up to 32; HP = HS + 16 in the keep forms): u and rhs in both
// halves and, with keep, the keep bits (KW = 4 x THREADS/32 + 4 words a
// slot) and one plane's keep as copied (HS):
//   nsw = 1: 5 x 4 x 384 words = 30,720 B (keep 5 x (4 x 400 + 28) + 384:
//            34,096), 192 threads
//   nsw = 2: 7 x 4 x 800 words = 89,600 B (keep 7 x (4 x 816 + 56) + 800:
//            96,160), 416 threads
// over the 48 KB a launch gets by default, so the launch raises the limit
// once per kernel and device (march_smem, march_limit). At nsw 2 both
// forms fit two blocks an SM (2 x (96,160 + 1,024 reserved) of 200,704 B,
// the 196 KB carveout, which leaves 60 KB of L1)
// if a thread holds 72 registers or fewer (65,536 / 832 threads, in steps
// of 8): the empty form needs 72, and the keep form's own launch bound
// asks ptxas for two blocks (an explicit specialization of the kernel
// below, so every file that includes this one gets the same form;
// sweepcost.cu compiles it and never launches it: a minimum of one block
// on the other forms' bound made ptxas give them 4-32 registers more, and
// the empty form one block). rbgs_stream.cu lists each form's registers;
// fst_march_blocks_per_sm asks the card how many blocks an SM holds.
#pragma once

#include "common.cuh"

namespace {

enum Variant { kFull = 0, kNoSel, kNoIota, kNoRoll, kNoZn, kArith,
               kCoalesced };

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
  // the coalesced loads (COAL): quad owner t also copies cells t + i*NQ,
  // i = 0..3, of the plane in row-major order: column t % L of rows
  // t / L + i*RS
  static constexpr int RS = LY / 4;
  static constexpr int WPI = THREADS / 32;           // keep bit words a copy
  static constexpr int KW = 4 * WPI + 4;  // keep bit words a plane, and 4
                                          // a neighbour's window may reach
  static_assert(kTx % 4 == 0 && M % 2 == 0 && HW % 2 == 0,
                "x0 even, rows of whole quads");
  static_assert(4 * 2 * NSW <= 32, "the update mask: 4 bits a half-sweep");
  static_assert(NQ == RS * L && NQ % 4 == 0,
                "a plane is four copies of whole rows, of whole quads");
};

// a colour half's stride in the ring: HS words, and 16 more where a
// plane's loads are coalesced (COAL), so that one word of the two halves,
// which lanes 2i and 2i+1 write, sits in two banks 16 apart
template <int NSW, bool COAL>
constexpr int half_stride() {
  return March<NSW>::HS + (COAL ? 16 : 0);
}

// a form's dynamic shared memory: u and rhs in both halves and, with keep,
// the plane's keep bits and one plane's keep of its black cells as copied
template <int NSW, bool KEEP, int V = kFull>
constexpr int march_smem() {
  using G = March<NSW>;
  return (G::R * 4 * half_stride<NSW, KEEP || V == kCoalesced>() +
          (KEEP ? G::R * G::KW + G::HS : 0)) *
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
  const unsigned char* table;   // KEEP: a block's byte, 0 where its
                                // footprint's keep is 1 throughout
};

// one float from global to shared memory by cp.async (through the L1),
// zeros where `ok` is false (src is then not read); cp_wait makes this
// thread's copies visible to itself, a barrier then to the block
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
// shared-memory loads and stores. Its quad is cells 4t .. 4t+3 of the
// plane in row-major order (t = threadIdx.x; L = 4*HQ), and f = 2t.
template <int NSW, bool KEEP, bool PADDED, int V, bool FACE>
struct Marcher {
  using G = March<NSW>;
  // the ring holds planes -1 and D (the padded field's ghosts, or zeros)
  static constexpr bool GHOSTS = PADDED || V == kNoSel;
  static constexpr bool SPLICE = !GHOSTS;
  // a plane's loads: coalesced cells by cp.async (fetch, land) in the keep
  // forms and kCoalesced, the thread's own quad through registers (read,
  // write) in the others
  static constexpr bool COAL = KEEP || V == kCoalesced;
  static constexpr int HP = half_stride<NSW, COAL>();

  const PassArgs& p;
  const int x0, y0;
  float* const u;      // [R][2][HP]
  float* const rh;     // [R][2][HP]
  unsigned* const kb;  // [R][KW]: bit t % 32 of word i*WPI + t / 32 whether
                       // copy i of thread t is a black cell whose keep is
                       // not 0 (KEEP)
  float* const kc;     // [HS]: the black cells' keep as copied, at their
                       // words of a half, one plane at a time (KEEP)
  unsigned solid;      // bit s: slot s's plane has a black cell in the
                       // domain whose keep is not 1 (KEEP)
  bool active;         // the plane has this thread's quad
  int f, row, lx0, rpar;
  unsigned vm;       // bit 4h + 2*off + c: cell lx0 + off + 2c updated in h
  unsigned lm;       // bit c (4 + c): cell lx0 + c holds u (rhs) (!COAL);
                     // bit i: copy i is of a cell in the domain (COAL)
  int uo, ro, ko;    // the offsets in a plane of fin, rhs (and keep) of the
                     // quad (!COAL), or of copy 0 (COAL)
  int cpar;          // the parity of copy 0's cell on plane 0 (COAL)
  int kpos;          // 32 * word + bit of the quad's first cell in a slot's
                     // keep bits (KEEP)
  float pu[4], pr[4];   // the plane in flight (!COAL)

  __device__ Marcher(const PassArgs& args, int x0_, int y0_, float* smem)
      : p(args), x0(x0_), y0(y0_), u(smem), rh(u + G::R * 2 * HP),
        kb(reinterpret_cast<unsigned*>(rh + G::R * 2 * HP)),
        kc(rh + G::R * 2 * HP + G::R * G::KW), solid(0) {
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
    if constexpr (COAL) {   // copy i: column t % L of row t / L + i*RS
      const int cy = y0 + t / G::L, cx = x0 + t % G::L;
      cpar = (cx + cy) & 1;
      lm = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gyi = cy + i * G::RS;
        lm |= static_cast<unsigned>(active && cx >= 0 && cx < p.W &&
                                    gyi >= 0 && gyi < p.H) << i;
      }
      uo = cy * p.W + cx;
      ro = cy * p.rsy + cx;
      ko = cy * p.ksy + cx;
      // the quad's cells 4t .. 4t+3 are copy band b = 4t / NQ of threads
      // tl .. tl+3, tl = 4t - b*NQ: bits tl % 32 .. of word b*WPI + tl / 32
      const int b = 4 * t / G::NQ, tl = 4 * t - b * G::NQ;
      kpos = (b * G::WPI + (tl >> 5)) * 32 + (tl & 31);
    } else {
      uo = PADDED ? (gy + 1) * (p.W + 2) + gx0 + 1 : gy * p.W + gx0;
      ro = gy * p.rsy + gx0;
    }
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
    }
  }

  // step 3: the registers into slot s as colour halves: the even cells
  // (parity e) at f, f+1 of half e, the odd ones in half e^1
  __device__ void write(int s, int q) {
    if (!active) return;
    const int e = (rpar ^ q) & 1;
    float* us = u + s * 2 * HP + f;
    float* rs = rh + s * 2 * HP + f;
    st2(us + e * HP, pu[0], pu[2]);
    st2(us + (e ^ 1) * HP, pu[1], pu[3]);
    st2(rs + e * HP, pr[0], pr[2]);
    st2(rs + (e ^ 1) * HP, pr[1], pr[3]);
  }

  // step 1 (COAL): plane q's copies into slot s, straight from global
  // memory. Copy i of thread t is cell t + i*NQ of the ring plane in
  // row-major order, so a warp's copy reads 32 consecutive words of one row
  // or two; a thread's four are one column, RS rows apart. Cell c goes to
  // word c / 2 of the half of its parity, where its quad's owner reads it;
  // with keep, a black cell's keep goes to its word of kc. Zeros where the
  // ring holds nothing of the field, as in read.
  __device__ void fetch(int s, int q) {
    if (!active) return;
    const bool qin = q >= 0 && q < p.D;
    const int e = (cpar ^ q) & 1;   // the half of copy 0
    const int w = threadIdx.x >> 1;
    const float* fu = p.fin + static_cast<long>(q) * p.H * p.W + uo;
    const float* fr = p.rhs + static_cast<long>(q) * p.rsz + ro;
    const float* fk =
        KEEP ? p.keep + static_cast<long>(q) * p.ksz + ko : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hf = e ^ (i * G::RS & 1), wi = w + i * (G::NQ / 2);
      const bool ok = qin && (!FACE || (lm >> i) & 1);
      cp4(u + (s * 2 + hf) * HP + wi, ok ? fu + i * G::RS * p.W : p.fin, ok);
      cp4(rh + (s * 2 + hf) * HP + wi, ok ? fr + i * G::RS * p.rsy : p.rhs,
          ok);
      if (KEEP && hf == 0)
        cp4(kc + wi, ok ? fk + i * G::RS * p.ksy : p.keep, ok);
    }
    cp_commit();
  }

  // step 3 (COAL): wait for this thread's copies of plane q into slot s;
  // with keep, gather the keep bits (keep != 0) of a warp's 32 copies into
  // word i*WPI + t / 32 of kb for copy i, and return whether a black cell
  // of the domain among this thread's copies has a keep other than 1
  __device__ bool land(int s, int q) {
    cp_wait();
    bool marked = false;
    if constexpr (KEEP) {
      const int e = (cpar ^ q) & 1;
      const int w = threadIdx.x >> 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool nz = false;
        if (active && (e ^ (i * G::RS & 1)) == 0) {
          const float k = kc[w + i * (G::NQ / 2)];
          nz = k != 0.0f;
          marked |= (lm >> i & 1) && k != 1.0f;
        }
        const unsigned bits = __ballot_sync(0xffffffffu, nz);
        if ((threadIdx.x & 31) == 0)
          kb[s * G::KW + i * G::WPI + (threadIdx.x >> 5)] = bits;
      }
    }
    return marked;
  }

  // the barrier that ends a step whose last half landed a plane in slot s:
  // with keep, it also marks in `solid` whether that plane has a black cell
  // whose keep is not 1
  __device__ void landed(int s, bool marked) {
    if constexpr (KEEP) {
      const unsigned bit = 1u << s;
      solid = __syncthreads_or(marked) ? solid | bit : solid & ~bit;
    } else {
      __syncthreads();
    }
  }

  // bits pos .. pos+31 of slot t's keep bits (a pos below 0 reads the
  // shared memory before them: only for cells no half-sweep updates)
  __device__ unsigned kwin(int t, int pos) const {
    const unsigned* k = kb + t * G::KW + (pos >> 5);
    return __funnelshift_r(k[0], k[1], pos & 31);
  }

  // v times the keep of the black cell whose bit is bit 0 of b
  __device__ static float kept(float v, unsigned b) {
    return __fmul_rn(v, b & 1 ? 1.0f : 0.0f);
  }

  // the other colour's words of slot t at this thread's pairs
  __device__ const float* other(int t, int col) const {
    return u + (t * 2 + (col ^ 1)) * HP + f;
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
      float* me = u + (s * 2 + col) * HP + f;
      const float2 v = ld2(me), b = ld2(rh + (s * 2 + col) * HP + f);
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
    float* me = u + (s * 2 + col) * HP + f;
    const float* o = other(s, col);
    // x: the other colour at k+off-1, k+off (cell A) and k+off, k+off+1 (B)
    const float2 v = ld2(o);
    const float e3 = o[off ? 2 : -1];
    float xpa = off ? v.y : v.x, xma = off ? v.x : e3;
    float xpb = off ? e3 : v.y, xmb = off ? v.y : v.x;
    float2 yp = ld2(o + G::HW), ym = ld2(o - G::HW);
    float2 zp = ld2(other(sp, col)), zm = ld2(other(sm, col));
    // the red half reads its black neighbours post-keep (relax multiplies
    // the field by keep after each sweep): the ring holds them pre-keep, so
    // where one of the three planes has a black cell whose keep is not 1,
    // each is multiplied by its keep bit (a uniform branch: most blocks
    // hold no solid)
    if (KEEP && col == 1 && ((solid >> s | solid >> sp | solid >> sm) & 1)) {
      // the bit rows of row + 1 and row - 1: L on, or L + the copy's
      // 32*WPI - NQ spare bits where the row crosses into the next copy
      constexpr int PAD = 32 * G::WPI - G::NQ;
      const int dyp = G::L + (row % G::RS == G::RS - 1 ? PAD : 0);
      const int dym = G::L + (row % G::RS == 0 ? PAD : 0);
      const int k0 = kpos + off;
      const unsigned bx = kwin(s, k0 - 1);   // cells lx0+off-1, +1, +3
      xma = kept(xma, bx);
      xpa = kept(xpa, bx >> 2);
      xmb = kept(xmb, bx >> 2);
      xpb = kept(xpb, bx >> 4);
      const unsigned by = kwin(s, k0 + dyp), bm = kwin(s, k0 - dym);
      const unsigned bp = kwin(sp, k0), bz = kwin(sm, k0);
      yp = make_float2(kept(yp.x, by), kept(yp.y, by >> 2));
      ym = make_float2(kept(ym.x, bm), kept(ym.y, bm >> 2));
      zp = make_float2(kept(zp.x, bp), kept(zp.y, bp >> 2));
      zm = make_float2(kept(zm.x, bz), kept(zm.y, bz >> 2));
    }
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
    const float2 b = ld2(rh + (s * 2 + col) * HP + f);
    const float va = relax1(b.x, ta, p.a, p.crec);
    const float vb = relax1(b.y, tb, p.a, p.crec);
    put(me, bits, va, vb);
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
    const float* ev = u + (s * 2 + e) * HP + fo;
    const float* od = u + (s * 2 + (e ^ 1)) * HP + fo;
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
    if constexpr (COAL) {
      fetch(0, zlo);
      landed(0, land(0, zlo));
    } else {
      read(zlo);
      write(0, zlo);
      __syncthreads();
    }
    // unrolled by R: plane j0 + d is in slot d, so every slot is a
    // constant and every shared-memory address an offset from the quad's
    for (int j0 = zlo; j0 <= zend; j0 += G::R) {
#pragma unroll
      for (int d = 0; d < G::R; ++d) {
        const int j = j0 + d;
        if (j > zend) break;
        const bool more = j + 1 <= zhi;
        if constexpr (COAL) {
          if (more) fetch(ring(d + 1), j + 1);
        } else {
          if (more) read(j + 1);
        }
#pragma unroll
        for (int h = 0; h < 2 * NSW; ++h) {
          if (!COAL && h == 2 * NSW - 1 && more) write(ring(d + 1), j + 1);
          const int q = j - 1 - h;
          if (q >= max(zs - M + h + 1, 0) &&
              q <= min(ze + M - 2 - h, p.D - 1))
            half(h, q, ring(d - 1 - h), ring(d - h), ring(d - 2 - h));
          if (COAL && h == 2 * NSW - 1 && more)
            landed(ring(d + 1), land(ring(d + 1), j + 1));
          else
            __syncthreads();
        }
        if (j - M >= zs) store(j - M, ring(d - M));
      }
    }
  }
};

// One block's march in one form: a block whose ring plane reaches past the
// domain's x or y faces takes the splicing path (FACE).
template <int NSW, bool KEEP, bool PADDED, int V>
__device__ __forceinline__ void march(const PassArgs& args, int x0, int y0,
                                      float* smem) {
  using G = March<NSW>;
  if (x0 < 0 || y0 < 0 || x0 + G::L > args.W || y0 + G::LY > args.H)
    Marcher<NSW, KEEP, PADDED, V, true>(args, x0, y0, smem).run();
  else
    Marcher<NSW, KEEP, PADDED, V, false>(args, x0, y0, smem).run();
}

// PADDED: fin is the padded (D+2, H+2, W+2) field (sweep 1: its ghost cells
// are loaded and read, never spliced). Otherwise fin is the packed pre-keep
// carry. rhs and keep are interior (D, H, W) views with z/y strides and x
// stride 1; out is packed. With KEEP, a block whose table byte is 0 runs the
// keep-free form (kCoalesced), whose values are the keep form's there.
template <int NSW, bool KEEP, bool PADDED, int V>
__device__ __forceinline__ void march_block(const PassArgs& args) {
  static_assert(V == kFull || (!KEEP && !PADDED),
                "the variants exist for the empty-scene pass only");
  using G = March<NSW>;
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * kTx - G::M;
  const int y0 = blockIdx.y * kTy<NSW> - G::M;
  if constexpr (KEEP) {
    if (!args.table[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x]) {
      march<NSW, false, PADDED, kCoalesced>(args, x0, y0, smem);
      return;
    }
  }
  march<NSW, KEEP, PADDED, V>(args, x0, y0, smem);
}

template <int NSW, bool KEEP, bool PADDED, int V = kFull>
__global__ void __launch_bounds__(March<NSW>::THREADS)
    rbgs_march_kernel(const PassArgs args) {
  march_block<NSW, KEEP, PADDED, V>(args);
}

// the keep form at nsw 2, bounded for two blocks an SM (72 registers)
template <>
__global__ void __launch_bounds__(March<2>::THREADS, 2)
    rbgs_march_kernel<2, true, false, kFull>(const PassArgs args) {
  march_block<2, true, false, kFull>(args);
}

// the form's dynamic shared-memory limit on the current device, raised once
// per kernel and device
template <int NSW, bool KEEP, bool PADDED, int V>
cudaError_t march_limit() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(rbgs_march_kernel<NSW, KEEP, PADDED, V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           march_smem<NSW, KEEP, V>());
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// the blocks of a form that one SM of the current device holds at once,
// with the dynamic shared memory the form launches with
template <int NSW, bool KEEP, bool PADDED>
int march_blocks(int* blocks) {
  cudaError_t e = march_limit<NSW, KEEP, PADDED, kFull>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rbgs_march_kernel<NSW, KEEP, PADDED, kFull>,
        March<NSW>::THREADS, march_smem<NSW, KEEP>());
  return static_cast<int>(e);
}

template <int NSW, bool KEEP, bool PADDED, int V = kFull>
int launch_march(const void* fin, const void* rhs, int rsz, int rsy,
                 const void* keep, int ksz, int ksy, void* out, int D, int H,
                 int W, float a, float crec, int neg_mask, void* stream,
                 const void* table = nullptr) {
  const auto kernel = rbgs_march_kernel<NSW, KEEP, PADDED, V>;
  constexpr int smem = march_smem<NSW, KEEP, V>();
  const cudaError_t e = march_limit<NSW, KEEP, PADDED, V>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const PassArgs args{static_cast<const float*>(fin),
                      static_cast<const float*>(rhs), rsz, rsy,
                      static_cast<const float*>(keep), ksz, ksy,
                      static_cast<float*>(out), D, H, W, a, crec, neg_mask,
                      static_cast<const unsigned char*>(table)};
  const dim3 grid(fst::cdiv(W, kTx), fst::cdiv(H, kTy<NSW>),
                  fst::cdiv(D, kChunk));
  kernel<<<grid, March<NSW>::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return fst::launch_status();
}

}  // namespace
