// The DMA-issue probe's kernel: one z-blocked windowed stream over a
// (D, H, W) f32 or bf16 array, o = a + b or o = (a + b) + (alo[0] + ahi[0]),
// with two loaders: per-thread vector loads or TMA boxes.
//
// Replaces the kernel bodies of tools/exp_dma.py (ROADMAP B23), which
// stream z-blocks of `blk` planes through VMEM with hb = 2 halo planes:
//   - copy2 (:98, k2 :95): o = a + b, one mid window per operand;
//   - copy2h (:108, k2h :105): o = (a + b) + (alo[0] + ahi[0]) with the lo,
//     mid and hi windows as three BlockSpecs per operand (index maps
//     :83-93: lo = hb*max(k*r - 1, 0), hi = hb*min(k*r + r, nhb - 1),
//     r = blk/hb, nhb = ceil(D/hb));
//   - manual2 (:154, kman :123-152): o = a + b out of one merged
//     (blk + 2hb)-plane window per operand starting at
//     clip(k*blk - hb, 0, D - E), double-buffered with make_async_copy
//     (D % blk == 0 only).
// The TPU question was whether time follows DMA issues or bytes. On Hopper
// it is per-thread loads against the Tensor Memory Accelerator (TMA):
//   - ldg (copy2, copy2h): a block of 32 x 8 threads owns a tile of
//     32*VEC x 8 (x, y) cells of one z-block; each thread streams one
//     16-byte vector (VEC = 4 f32 or 8 bf16) per plane where W allows it,
//     else one element (the ragged test shapes). The window planes that no
//     output reads (a's planes 1..hb-1, all of b's) are loaded with
//     ld.volatile, which the compiler may not delete, so the kernel moves
//     the bytes the JAX tool counts, as csrc/hbm.cu does;
//   - tma (copy2, copy2h): a block of 128 threads owns a tile of 256 bytes
//     x 8 rows (64 f32 or 128 bf16 columns) of one z-block. One thread
//     issues one cp.async.bulk.tensor box per window per operand (2 for
//     copy2, 6 for copy2h) into shared memory, all completing on one
//     mbarrier whose expected bytes are the full boxes, clipped or not
//     (TMA fills the part outside the array with zeros and counts it);
//     then every thread reads one 16-byte vector a plane and stores the
//     result with plain stores;
//   - manual2 (tma only): the block walks `walk` consecutive z-blocks of
//     its tile, two slots of one merged box per operand each, the next
//     z-block's boxes issued before the current one is waited for: the
//     counterpart of the slot/semaphore ring. A __syncthreads at the end of
//     each z-block frees the slot that the next issue overwrites.
// The tensor maps are encoded on the host for the call's pointers (the
// driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the link needs no libcuda) and passed as
// __grid_constant__ kernel parameters, so a captured CUDA graph replays
// them. TMA needs 16-byte global strides and a 16-byte-aligned base: W a
// multiple of 4 in f32 and of 8 in bf16; the wrapper refuses the rest.
//
// What bounds it on the H100: bytes. It does one to three adds a cell, so
// it times the card's streaming rate for this window pattern and loader;
// the halo planes are re-reads of neighbouring z-blocks, which the 50 MB L2
// may serve. Shared memory per block: 2 x blk planes of 2 KB (copy2), 2 x
// (blk + 2hb) (copy2h), 2 slots x 2 x (blk + 2hb) (manual2: 160 KB at blk
// 16), under the 227 KB a block may take.
//
// Numerics: each add is one __fadd_rn in f32, rounded to bf16 with
// __float2bfloat16_rn where the type is bf16: torch's own bf16 add (upcast,
// add, round), in the JAX body's order, so bitwise equal to the plain torch
// version (kernels/dma.py).

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <cstdio>

#include "common.cuh"

namespace {

constexpr int kRowBytes = 256;  // a TMA box row: 64 f32 or 128 bf16
constexpr int kRows = 8;        // rows of a TMA tile
constexpr int kPlaneBytes = kRowBytes * kRows;
constexpr int kTmaThreads = kPlaneBytes / 16;  // one 16-byte vector a plane
constexpr int kLdgX = 32, kLdgY = 8;
// 227 KB, the most a block may take, static shared memory included
constexpr int kMaxSmem = 232448 - 64;

enum Form { kCopy2 = 0, kCopy2h = 1, kManual2 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of T moved as one load or store
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};

// u + v element by element, each sum rounded to T as torch rounds it
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> add(const Pack<T, N>& u,
                                          const Pack<T, N>& v) {
  Pack<T, N> r;
#pragma unroll
  for (int e = 0; e < N; ++e)
    r.v[e] = from_f<T>(__fadd_rn(to_f(u.v[e]), to_f(v.v[e])));
  return r;
}

// A load whose value no output reads: ld.volatile, which the compiler may
// neither delete nor merge, so the bytes move.
template <int BYTES>
__device__ __forceinline__ void touch(const void* p);
template <>
__device__ __forceinline__ void touch<16>(const void* p) {
  unsigned r0, r1, r2, r3;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "l"(p));
}
template <>
__device__ __forceinline__ void touch<4>(const void* p) {
  unsigned r0;
  asm volatile("ld.volatile.global.u32 %0, [%1];\n" : "=r"(r0) : "l"(p));
}
template <>
__device__ __forceinline__ void touch<2>(const void* p) {
  unsigned short r0;
  asm volatile("ld.volatile.global.u16 %0, [%1];\n" : "=h"(r0) : "l"(p));
}

// lo and hi window starts of z-block k (exp_dma.py:83-93)
__device__ __forceinline__ int window_lo(int k, int blk, int hb) {
  return hb * max(k * (blk / hb) - 1, 0);
}
__device__ __forceinline__ int window_hi(int k, int blk, int hb, int D) {
  const int r = blk / hb, nhb = (D + hb - 1) / hb;
  return hb * min(k * r + r, nhb - 1);
}

// ---- ldg: per-thread vector loads ------------------------------------

template <typename T, int VEC, bool HALO>
__global__ void __launch_bounds__(kLdgX* kLdgY)
    dma_ldg_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ o, int D, int H, int W, int blk, int hb) {
  using P = Pack<T, VEC>;
  const int x = (blockIdx.x * kLdgX + threadIdx.x) * VEC;
  const int y = blockIdx.y * kLdgY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long plane = static_cast<long>(H) * W;
  const long off = static_cast<long>(y) * W + x;
  const int k = blockIdx.z;
  const int z0 = k * blk, z1 = min(z0 + blk, D);
  auto at = [&](const T* base, int z) {
    return reinterpret_cast<const P*>(base + z * plane + off);
  };

  P lohi;
  if (HALO) {
    const int zl = window_lo(k, blk, hb), zh = window_hi(k, blk, hb, D);
    for (int w = 0; w < 2; ++w) {
      const int zw = w ? zh : zl;
      const int ze = min(zw + hb, D);
      for (int z = zw; z < ze; ++z) {
        if (z > zw) touch<sizeof(P)>(at(a, z));
        touch<sizeof(P)>(at(b, z));
      }
    }
    lohi = add(*at(a, zl), *at(a, zh));
  }
#pragma unroll 4
  for (int z = z0; z < z1; ++z) {
    P v = add(*at(a, z), *at(b, z));
    if (HALO) v = add(v, lohi);
    *reinterpret_cast<P*>(o + z * plane + off) = v;
  }
}

// ---- tma: boxes into shared memory, completing on an mbarrier --------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one box of the map's box shape at (x, y, z) into shared `dst`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

// The thread's 16-byte vector of a tile plane: row r, columns from c.
struct TileLane {
  int r, c, x, y;
  bool live;
  template <typename T>
  __device__ TileLane(int x0, int y0, int H, int W, T*) {
    constexpr int vec = 16 / sizeof(T);
    r = threadIdx.x / (kRowBytes / 16);
    c = (threadIdx.x % (kRowBytes / 16)) * vec;
    x = x0 + c;
    y = y0 + r;
    live = x < W && y < H;
  }
};

template <typename T>
__device__ __forceinline__ const Pack<T, 16 / sizeof(T)>& plane_at(
    const unsigned char* box, int p, const TileLane& t) {
  return *reinterpret_cast<const Pack<T, 16 / sizeof(T)>*>(
      box + p * kPlaneBytes + t.r * kRowBytes + t.c * sizeof(T));
}

// copy2 / copy2h, one z-block per block. Shared: a_mid, b_mid (blk planes
// each), then for copy2h a_lo, a_hi, b_lo, b_hi (hb planes each).
template <typename T, bool HALO>
__global__ void __launch_bounds__(kTmaThreads)
    dma_tma_kernel(const __grid_constant__ CUtensorMap am,
                   const __grid_constant__ CUtensorMap ah,
                   const __grid_constant__ CUtensorMap bm,
                   const __grid_constant__ CUtensorMap bh, T* __restrict__ o,
                   int D, int H, int W, int blk, int hb) {
  using P = Pack<T, 16 / sizeof(T)>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar;
  unsigned char* sa = aligned_smem(smem_raw);
  unsigned char* sb = sa + blk * kPlaneBytes;
  unsigned char* halo = sb + blk * kPlaneBytes;  // a_lo, a_hi, b_lo, b_hi
  const int x0 = blockIdx.x * (kRowBytes / sizeof(T));
  const int y0 = blockIdx.y * kRows;
  const int k = blockIdx.z, z0 = k * blk;
  const int zl = window_lo(k, blk, hb), zh = window_hi(k, blk, hb, D);
  if (threadIdx.x == 0) bar_init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int planes = 2 * blk + (HALO ? 4 * hb : 0);
    bar_expect(&bar, planes * kPlaneBytes);
    tma_box(sa, &am, x0, y0, z0, &bar);
    tma_box(sb, &bm, x0, y0, z0, &bar);
    if (HALO) {
      const int hp = hb * kPlaneBytes;
      tma_box(halo, &ah, x0, y0, zl, &bar);
      tma_box(halo + hp, &ah, x0, y0, zh, &bar);
      tma_box(halo + 2 * hp, &bh, x0, y0, zl, &bar);
      tma_box(halo + 3 * hp, &bh, x0, y0, zh, &bar);
    }
  }
  bar_wait(&bar, 0);
  const TileLane t(x0, y0, H, W, o);
  if (!t.live) return;
  P lohi;
  if (HALO)
    lohi = add(plane_at<T>(halo, 0, t), plane_at<T>(halo, hb, t));
  const long plane = static_cast<long>(H) * W;
  const int n = min(blk, D - z0);
  for (int p = 0; p < n; ++p) {
    P v = add(plane_at<T>(sa, p, t), plane_at<T>(sb, p, t));
    if (HALO) v = add(v, lohi);
    *reinterpret_cast<P*>(o + (z0 + p) * plane + static_cast<long>(t.y) * W +
                          t.x) = v;
  }
}

// manual2: the block walks z-blocks [kb, kb + walk) of its tile; slot s
// holds a's and b's merged (blk + 2hb)-plane boxes.
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    dma_manual_kernel(const __grid_constant__ CUtensorMap ae,
                      const __grid_constant__ CUtensorMap be,
                      T* __restrict__ o, int D, int H, int W, int blk, int hb,
                      int walk) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar[2];
  const int E = blk + 2 * hb;
  const int box = E * kPlaneBytes;
  unsigned char* slots = aligned_smem(smem_raw);  // slot s: a at 2s, b 2s+1
  const int x0 = blockIdx.x * (kRowBytes / sizeof(T));
  const int y0 = blockIdx.y * kRows;
  const int kb = blockIdx.z * walk, ke = min(kb + walk, D / blk);
  auto start = [&](int k) { return min(max(k * blk - hb, 0), D - E); };
  auto issue = [&](int s, int k) {
    bar_expect(&bar[s], 2 * box);
    tma_box(slots + 2 * s * box, &ae, x0, y0, start(k), &bar[s]);
    tma_box(slots + (2 * s + 1) * box, &be, x0, y0, start(k), &bar[s]);
  };
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
  }
  __syncthreads();
  if (threadIdx.x == 0 && kb < ke) issue(0, kb);
  const TileLane t(x0, y0, H, W, o);
  const long plane = static_cast<long>(H) * W;
  for (int k = kb, i = 0; k < ke; ++k, ++i) {
    const int s = i & 1;
    if (threadIdx.x == 0 && k + 1 < ke) issue(s ^ 1, k + 1);
    bar_wait(&bar[s], (i >> 1) & 1);
    if (t.live) {
      const unsigned char* sa = slots + 2 * s * box;
      const int off = k * blk - start(k);  // mid planes inside the window
      for (int p = 0; p < blk; ++p) {
        const auto v = add(plane_at<T>(sa, off + p, t),
                           plane_at<T>(sa + box, off + p, t));
        *reinterpret_cast<Pack<T, 16 / sizeof(T)>*>(
            o + (k * blk + p) * plane + static_cast<long>(t.y) * W + t.x) = v;
      }
    }
    __syncthreads();  // slot s is read: the next issue may overwrite it
  }
}

// ---- host side --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map of the (D, H, W) array at `base`, boxes of `planes` x 8 rows x
// 256 bytes; 0 or a CUDA error code.
int encode(CUtensorMap* map, const void* base, bool bf16, int D, int H, int W,
           int planes) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[2] = {W * es, static_cast<cuuint64_t>(H) * W * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / es), kRows,
                             static_cast<cuuint32_t>(planes)};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map,
         bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         3, const_cast<void*>(base), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "dma.cu: cuTensorMapEncodeTiled failed (%d)\n",
            static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory (over the 48 KB a
// launch gets by default); 0 or a CUDA error code.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int launch(const void* a, const void* b, void* o, int D, int H, int W,
           int form, int tma, int blk, int hb, int walk, int vec,
           cudaStream_t s) {
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(o);
  const bool halo = form == kCopy2h;
  if (!tma) {
    constexpr int V = 16 / sizeof(T);
    const int cols = vec == V ? W / V : W;
    const dim3 grid(fst::cdiv(cols, kLdgX), fst::cdiv(H, kLdgY),
                    fst::cdiv(D, blk));
    const dim3 block(kLdgX, kLdgY);
    if (vec == V) {
      if (halo)
        dma_ldg_kernel<T, V, true><<<grid, block, 0, s>>>(at, bt, ot, D, H, W,
                                                          blk, hb);
      else
        dma_ldg_kernel<T, V, false><<<grid, block, 0, s>>>(at, bt, ot, D, H,
                                                           W, blk, hb);
    } else {
      if (halo)
        dma_ldg_kernel<T, 1, true><<<grid, block, 0, s>>>(at, bt, ot, D, H, W,
                                                          blk, hb);
      else
        dma_ldg_kernel<T, 1, false><<<grid, block, 0, s>>>(at, bt, ot, D, H,
                                                           W, blk, hb);
    }
    return fst::launch_status();
  }
  const bool bf16 = sizeof(T) == 2;
  const int tx = kRowBytes / sizeof(T);
  CUtensorMap am, ah, bm, bh;
  if (form == kManual2) {
    const int E = blk + 2 * hb;
    int rc = encode(&am, a, bf16, D, H, W, E);
    if (!rc) rc = encode(&bm, b, bf16, D, H, W, E);
    if (rc) return rc;
    const int nblk = D / blk;
    const dim3 grid(fst::cdiv(W, tx), fst::cdiv(H, kRows),
                    fst::cdiv(nblk, walk));
    const int smem = 4 * E * kPlaneBytes + 128;
    if ((rc = allow_smem(dma_manual_kernel<T>, smem))) return rc;
    dma_manual_kernel<T><<<grid, kTmaThreads, smem, s>>>(am, bm, ot, D, H, W,
                                                         blk, hb, walk);
    return fst::launch_status();
  }
  int rc = encode(&am, a, bf16, D, H, W, blk);
  if (!rc) rc = encode(&bm, b, bf16, D, H, W, blk);
  if (!rc && halo) rc = encode(&ah, a, bf16, D, H, W, hb);
  if (!rc && halo) rc = encode(&bh, b, bf16, D, H, W, hb);
  if (rc) return rc;
  const dim3 grid(fst::cdiv(W, tx), fst::cdiv(H, kRows), fst::cdiv(D, blk));
  const int smem = (2 * blk + (halo ? 4 * hb : 0)) * kPlaneBytes + 128;
  if (halo) {
    if ((rc = allow_smem(dma_tma_kernel<T, true>, smem))) return rc;
    dma_tma_kernel<T, true><<<grid, kTmaThreads, smem, s>>>(am, ah, bm, bh, ot,
                                                            D, H, W, blk, hb);
  } else {
    if ((rc = allow_smem(dma_tma_kernel<T, false>, smem))) return rc;
    dma_tma_kernel<T, false><<<grid, kTmaThreads, smem, s>>>(
        am, am, bm, bm, ot, D, H, W, blk, hb);
  }
  return fst::launch_status();
}

}  // namespace

extern "C" {

// o = the form's stream of a and b over z-blocks of blk planes: form 0
// copy2, 1 copy2h (halo windows of hb planes, hb dividing blk), 2 manual2
// (TMA only, D % blk == 0, D >= blk + 2hb, `walk` z-blocks a block). `tma`
// picks the loader; vec is the ldg loader's elements per thread (16 bytes'
// worth or 1). bf16 selects the element type (else f32). Refuses other
// combinations with cudaErrorInvalidValue.
int fst_dma_stream(const void* a, const void* b, void* o, int D, int H,
                   int W, int bf16, int form, int tma, int blk, int hb,
                   int walk, int vec, void* stream) {
  const int es = bf16 ? 2 : 4;
  const int E = blk + 2 * hb;
  if (D < 1 || H < 1 || W < 1 || blk < 1 || form < kCopy2 ||
      form > kManual2 || (form != kCopy2 && (hb < 1 || blk % hb)) ||
      (form == kManual2 && (!tma || D % blk || D < E || walk < 1)) ||
      (tma && (W * es % 16 ||
               (form == kManual2 ? 4 * E : 2 * blk + 4 * hb) * kPlaneBytes +
                       128 >
                   kMaxSmem)) ||
      (!tma && vec != 1 && vec != 16 / es) || (!tma && vec > 1 && W % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, b, o, D, H, W, form, tma, blk, hb,
                                      walk, vec, s)
              : launch<float>(a, b, o, D, H, W, form, tma, blk, hb, walk, vec,
                              s);
}

}  // extern "C"
