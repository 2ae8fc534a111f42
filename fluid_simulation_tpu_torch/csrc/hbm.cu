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
// Design. A block of 64 x 4 threads owns a tile of 64*VEC x 4 (x, y) cells
// of one z-block and walks its planes; each thread streams VEC = 4 cells as
// one 16-byte load or store where W is a multiple of 4 (otherwise VEC = 1,
// the ragged test shapes). The grid is (x tiles, y tiles, z-blocks): a
// 16 x 256 x 256 slab is 4 MB, far over a block's 227 KB of shared memory,
// so x and y are tiled too. The windows are read as the JAX tool reads them:
// alo[0] and ahi[0] into registers, and every other plane of the four
// windows (a's planes 1..hb-1, all of b's), which no output reads, is
// staged into a shared-memory slot with cp.async and never read. An
// ordinary load whose value is dead would be deleted by the compiler; an
// asynchronous copy to shared memory is not, so the kernel moves the bytes
// the JAX tool counts (3 + 4*hb/blk arrays with the windows) and computes
// exactly the JAX body's formula.
//
// What bounds it on the H100: bytes. Its f32 work is 1-2 operations a cell
// (30 with the chain, 0.03 ms of the f32 rate at 256^3 against 0.06 ms of
// bytes), so it times the card's streaming rate for this window pattern:
// the halo planes are re-reads of neighbouring z-blocks, which the 50 MB L2
// may serve, since the grid runs the z-blocks roughly in order.
//
// Numerics: every operation rounded on its own (__fadd_rn, __fmul_rn,
// -fmad=false), in the JAX body's order: bitwise equal to the plain torch
// version (kernels/hbm.py).

#include "common.cuh"

namespace {

constexpr int kTx = 64, kTy = 4;

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

// NIN streamed inputs (1: o = a + 1; 2: o = a + b), HALO windows, CHAIN the
// 14-step multiply-add chain. b is unused when NIN == 1.
template <int NIN, bool HALO, bool CHAIN, int VEC>
__global__ void __launch_bounds__(kTx * kTy)
    hbm_stream_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ o,
                      int D, int H, int W, int blk, int hb) {
  using L = Lane<VEC>;
  using T = typename L::T;
  __shared__ T sink[kTx * kTy];
  const int x = (blockIdx.x * kTx + threadIdx.x) * VEC;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= W || y >= H) return;
  const long plane = static_cast<long>(H) * W;
  const long off = static_cast<long>(y) * W + x;
  const int k = blockIdx.z;
  const int z0 = k * blk, z1 = min(z0 + blk, D);

  T lo = L::splat(0.0f), hi = L::splat(0.0f);
  if (HALO) {
    const int r = blk / hb, nhb = (D + hb - 1) / hb;
    const int zl = hb * max(k * r - 1, 0);
    const int zh = hb * min(k * r + r, nhb - 1);
    T* slot = &sink[threadIdx.y * kTx + threadIdx.x];
    for (int w = 0; w < 2; ++w) {
      const int zw = w ? zh : zl;
      const int ze = min(zw + hb, D);
      for (int z = zw; z < ze; ++z) {
        if (z > zw) L::stage(slot, a + z * plane + off);
        L::stage(slot, b + z * plane + off);
      }
    }
    lo = L::load(a + zl * plane + off);
    hi = L::load(a + zh * plane + off);
  }
  const float m = 1.0001f;
#pragma unroll 4
  for (int z = z0; z < z1; ++z) {
    const long i = z * plane + off;
    const T av = L::load(a + i);
    T v;
    if (NIN == 1) {
      v = L::add(av, L::splat(1.0f));
    } else {
      const T bv = L::load(b + i);
      if (CHAIN) {
        v = av;
#pragma unroll
        for (int s = 0; s < 14; ++s) v = L::step(v, bv, m);
      } else {
        v = L::add(av, bv);
      }
      if (HALO) v = L::add(L::add(v, lo), hi);
    }
    L::store(o + i, v);
  }
  if (HALO) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int NIN, bool HALO, bool CHAIN>
int launch(const void* a, const void* b, void* o, int D, int H, int W,
           int blk, int hb, int vec, void* stream) {
  const int cols = vec == 4 ? W / 4 : W;
  const dim3 grid(fst::cdiv(cols, kTx), fst::cdiv(H, kTy), fst::cdiv(D, blk));
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
// 1. Refuses other combinations with cudaErrorInvalidValue.
int fst_hbm_stream(const void* a, const void* b, void* o, int D, int H,
                   int W, int blk, int hb, int halo, int chain, int vec,
                   void* stream) {
  const bool two = b != nullptr;
  if (blk < 1 || (vec != 1 && vec != 4) || (vec == 4 && W % 4) ||
      (halo && (!two || hb < 1 || blk % hb)) || (chain && !halo))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!two) return launch<1, false, false>(a, b, o, D, H, W, blk, hb, vec,
                                           stream);
  if (!halo) return launch<2, false, false>(a, b, o, D, H, W, blk, hb, vec,
                                            stream);
  if (!chain) return launch<2, true, false>(a, b, o, D, H, W, blk, hb, vec,
                                            stream);
  return launch<2, true, true>(a, b, o, D, H, W, blk, hb, vec, stream);
}

}  // extern "C"
