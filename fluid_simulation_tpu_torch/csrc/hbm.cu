// The streaming-ceiling probe's kernel: one z-blocked windowed stream,
// o = f(a[, b]) over a (D, H, W) f32 array, in one launch.
//
// Replaces every kernel body of the JAX side's bandwidth probes (ROADMAP
// B23), which stream z-blocks of `blk` planes through VMEM, with optional
// lo/hi halo windows of `hb` planes on both inputs:
//   - tools/exp_hbm.py copy1 / copy1b (:75, :102): o = a + 1, blk 16 / 32;
//   - exp_hbm.py copy2 (:85), exp_hbm2.py copy2d (:78): o = a + b;
//   - exp_hbm.py copy2h (:112), exp_hbm2.py copy2hd (:88):
//     o = ((a + b) + alo[0]) + ahi[0];
//   - exp_hbm.py sweepish (:128), exp_hbm2.py arithd (:104): acc = a,
//     14 x acc = acc*1.0001 + b, o = (acc + alo[0]) + ahi[0].
// For z-block k (planes [k*blk, (k+1)*blk) clipped to D) with r = blk/hb
// and nhb = ceil(D/hb), the windows are the hb planes from
// lo = hb*max(k*r - 1, 0) and hi = hb*min(k*r + r, nhb - 1), clipped to D
// (the BlockSpec index maps of exp_hbm2.py:44-49); alo[0] and ahi[0] are
// a's planes lo and hi, broadcast over the block's planes.
//
// Design: one short work item a block, as dma.cu's copy2 has (a
// grid-stride or persistent grid ran slower there, PERF.md K17-dma). A
// block of 32 x 8 threads owns a tile of 32*VEC x 8 (x, y) cells, VEC = 4
// cells a thread as one 16-byte load or store where W is a multiple of 4
// and the pointers 16-byte aligned (otherwise VEC = 1, the ragged test
// shapes). Each z-block of each tile is cut into items of kGroup = 4
// planes (never across the z-block's end), numbered with the tile fastest,
// then the item, then the z-block (kernels/hbm.py::stream_items counts
// them), and the grid has one block an item: a thread issues all of its
// item's loads, 4 planes of each operand (8 16-byte loads in flight with
// two inputs), before its first add, then 4 stores. The work is the same
// at every blk for the forms without windows, so copy1_blk32 is copy1.
//
// The halo forms keep the JAX tool's windows, which belong to the z-block
// k = z / blk, not to the item (kernels/hbm.py::window_planes). Their
// planes that no output reads (a's planes 1..hb-1 of each window, all of
// b's) are staged into a shared-memory slot with cp.async and never read:
// an ordinary load whose value is dead would be deleted by the compiler,
// an asynchronous copy to shared memory is not. They are staged ONCE per
// z-block: the z-block's window planes, listed b(zw), a(zw+1), b(zw+1),
// .. for the lo window and then the hi one, are dealt out to its items in
// turn (entry i to item i % items; kernels/hbm.py::item_plan), so the
// kernel moves the window bytes that the JAX tool counts and
// tools/exp_hbm.py::window_bytes sums. alo[0] and ahi[0], which every
// output of the z-block adds, are read by each of its blk/4 items (4 times
// a z-block at blk 16), against once by the JAX tool's z-block: the other
// reads are re-reads of two planes the block scheduler has just streamed,
// which the 50 MB L2 serves.
//
// What bounds it on the H100: bytes. Its f32 work is 1-2 operations a cell
// (30 with the chain, 0.03 ms of the f32 rate at 256^3 against 0.06 ms of
// bytes), so it times the card's streaming rate for this window pattern.
//
// Numerics: every operation rounded on its own (__fadd_rn, __fmul_rn,
// -fmad=false), in the JAX body's order: bitwise equal to the plain torch
// version (kernels/hbm.py).

#include "common.cuh"

namespace {

constexpr int kTx = 32, kTy = 8;
constexpr int kGroup = 4;   // planes of a work item

template <int VEC>
struct Lane;

template <>
struct Lane<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static T splat(float s) { return make_float4(s, s, s, s); }
  __device__ static T add(T u, T v) {
    return make_float4(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y),
                       __fadd_rn(u.z, v.z), __fadd_rn(u.w, v.w));
  }
  // acc*m + y, two roundings
  __device__ static T step(T acc, T y, float m) {
    return make_float4(__fadd_rn(__fmul_rn(acc.x, m), y.x),
                       __fadd_rn(__fmul_rn(acc.y, m), y.y),
                       __fadd_rn(__fmul_rn(acc.z, m), y.z),
                       __fadd_rn(__fmul_rn(acc.w, m), y.w));
  }
  // one 16-byte asynchronous copy global -> shared, never read
  __device__ static void stage(T* slot, const float* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(p)
                 : "memory");
  }
};

template <>
struct Lane<1> {
  using T = float;
  __device__ static T load(const float* p) { return *p; }
  __device__ static void store(float* p, T v) { *p = v; }
  __device__ static T splat(float s) { return s; }
  __device__ static T add(T u, T v) { return __fadd_rn(u, v); }
  __device__ static T step(T acc, T y, float m) {
    return __fadd_rn(__fmul_rn(acc, m), y);
  }
  __device__ static void stage(T* slot, const float* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(p)
                 : "memory");
  }
};

// the JAX tools' windows of z-block k (exp_hbm2.py:44-49): first planes
// of its lo and hi windows
__device__ __forceinline__ int window_lo(int k, int blk, int hb) {
  return hb * max(k * (blk / hb) - 1, 0);
}
__device__ __forceinline__ int window_hi(int k, int blk, int hb, int D) {
  return hb * min(k * (blk / hb) + blk / hb, (D + hb - 1) / hb - 1);
}

// the work items: groups of kGroup planes of each z-block of each tile,
// numbered with the tile fastest, then the group, then the z-block
struct Items {
  int D, blk, tx, tiles_x, tiles, groups, total;
  __host__ __device__ Items(int D_, int H, int W, int blk_, int tx_)
      : D(D_), blk(blk_), tx(tx_) {
    tiles_x = (W + tx - 1) / tx;
    tiles = tiles_x * ((H + kTy - 1) / kTy);
    groups = (blk + kGroup - 1) / kGroup;
    total = tiles * ((D + blk - 1) / blk) * groups;
  }
  // item q's tile corner (x0, y0), z-block k, group g, first plane z0 and
  // planes n (<= 0 for a group past the array's last plane)
  __device__ void at(int q, int& x0, int& y0, int& k, int& g, int& z0,
                     int& n) const {
    const int tile = q % tiles, zg = q / tiles;
    k = zg / groups;
    g = zg - k * groups;
    x0 = (tile % tiles_x) * tx;
    y0 = (tile / tiles_x) * kTy;
    z0 = k * blk + g * kGroup;
    n = min(min(kGroup, blk - g * kGroup), D - z0);
  }
};

// NIN streamed inputs (1: o = a + 1; 2: o = a + b), HALO windows, CHAIN the
// 14-step multiply-add chain. b is unused when NIN == 1.
template <int NIN, bool HALO, bool CHAIN, int VEC>
__global__ void __launch_bounds__(kTx * kTy)
    hbm_stream_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ o,
                      int D, int H, int W, int blk, int hb) {
  using L = Lane<VEC>;
  using T = typename L::T;
  const Items it(D, H, W, blk, kTx * VEC);
  int x0, y0, k, g, z0, n;
  it.at(blockIdx.x, x0, y0, k, g, z0, n);
  const int x = x0 + threadIdx.x * VEC, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long plane = static_cast<long>(H) * W;
  const long off = static_cast<long>(y) * W + x;

  T lohi[2];
  if (HALO) {
    // this item's share of the z-block's window planes: entries g,
    // g + groups, .. of b(zw), a(zw+1), b(zw+1), .. over both windows
    __shared__ T sink[kTx * kTy];
    T* slot = &sink[threadIdx.y * kTx + threadIdx.x];
    const int zl = window_lo(k, blk, hb), zh = window_hi(k, blk, hb, D);
    const int nl = 2 * (min(zl + hb, D) - zl) - 1;
    const int nh = 2 * (min(zh + hb, D) - zh) - 1;
    for (int i = g; i < nl + nh; i += it.groups) {
      const int e = i < nl ? i : i - nl;
      const int z = (i < nl ? zl : zh) + (e + 1) / 2;
      L::stage(slot, ((e & 1) ? a : b) + z * plane + off);
    }
    lohi[0] = L::load(a + zl * plane + off);
    lohi[1] = L::load(a + zh * plane + off);
  }
  if (n > 0) {
    T va[kGroup], vb[kGroup];
    const long base = z0 * plane + off;
#pragma unroll
    for (int p = 0; p < kGroup; ++p)
      if (p < n) {
        va[p] = L::load(a + base + p * plane);
        if (NIN == 2) vb[p] = L::load(b + base + p * plane);
      }
    const float m = 1.0001f;
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p >= n) continue;
      T v;
      if (NIN == 1) {
        v = L::add(va[p], L::splat(1.0f));
      } else {
        if (CHAIN) {
          v = va[p];
#pragma unroll
          for (int s = 0; s < 14; ++s) v = L::step(v, vb[p], m);
        } else {
          v = L::add(va[p], vb[p]);
        }
        if (HALO) v = L::add(L::add(v, lohi[0]), lohi[1]);
      }
      L::store(o + base + p * plane, v);
    }
  }
  if (HALO) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int stream_items(int D, int H, int W, int blk, int vec) {
  return Items(D, H, W, blk, kTx * vec).total;
}

template <int NIN, bool HALO, bool CHAIN>
int launch(const void* a, const void* b, void* o, int D, int H, int W,
           int blk, int hb, int vec, int grid, void* stream) {
  const dim3 block(kTx, kTy);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(o);
  if (vec == 4)
    hbm_stream_kernel<NIN, HALO, CHAIN, 4>
        <<<grid, block, 0, s>>>(af, bf, of, D, H, W, blk, hb);
  else
    hbm_stream_kernel<NIN, HALO, CHAIN, 1>
        <<<grid, block, 0, s>>>(af, bf, of, D, H, W, blk, hb);
  return fst::launch_status();
}

}  // namespace

extern "C" {

// o = the stream of a (and b) over z-blocks of blk planes; halo windows of
// hb planes (hb divides blk) when `halo`, the 14-step chain when `chain`
// (both need b). vec is 4 (W a multiple of 4, 16-byte aligned pointers) or
// 1; `grid` is the number of work items (stream_items), one block each.
// Refuses other combinations with cudaErrorInvalidValue.
int fst_hbm_stream(const void* a, const void* b, void* o, int D, int H,
                   int W, int blk, int hb, int halo, int chain, int vec,
                   int grid, void* stream) {
  const bool two = b != nullptr;
  if (D < 1 || H < 1 || W < 1 || blk < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && W % 4) || (halo && (!two || hb < 1 || blk % hb)) ||
      (chain && !halo) || grid != stream_items(D, H, W, blk, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!two) return launch<1, false, false>(a, b, o, D, H, W, blk, hb, vec,
                                           grid, stream);
  if (!halo) return launch<2, false, false>(a, b, o, D, H, W, blk, hb, vec,
                                            grid, stream);
  if (!chain) return launch<2, true, false>(a, b, o, D, H, W, blk, hb, vec,
                                            grid, stream);
  return launch<2, true, true>(a, b, o, D, H, W, blk, hb, vec, grid,
                               stream);
}

}  // extern "C"
