// The DMA-issue probe's kernels: z-blocked windowed streams over a (D, H, W)
// f32 or bf16 array, o = a + b or o = (a + b) + (alo[0] + ahi[0]), with two
// loaders: per-thread vector loads or TMA boxes.
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
// it is per-thread loads against the Tensor Memory Accelerator (TMA).
//
// copy2, the form that one PyTorch call (torch.add) also computes, is a
// stream at the card's bytes ceiling. Its two kernels cut each z-block of
// each (x, y) tile into plane groups (never across a z-block's end) and
// number these work items with the tile fastest, so the blocks in flight
// at once cover neighbouring tiles of one plane group. A block takes one
// item, and the grid has one block an item (kernels/dma.py::copy2_items):
// the block scheduler hands out short blocks as SMs free up, which keeps
// every SM busy to the end. A persistent grid of SMs x resident blocks,
// each walking its items through a 4-stage TMA ring, ran 3-12 % slower in
// every loader, type and blk on the H100 and was taken out (PERF.md §6,
// K17-dma). So copy2's work is the same at every blk:
//   - copy2_ldg_kernel: 32 x 8 threads over a tile of 32*VEC x 8 cells
//     (VEC = 4 f32 or 8 bf16 where W allows, else 1); an item is 4 planes,
//     and each thread issues its 8 16-byte loads (4 planes of both
//     operands) before the first add, then 4 16-byte stores;
//   - copy2_tma_kernel: 128 threads over a tile of 256 bytes x 8 rows; an
//     item is one plane: thread 0 issues one cp.async.bulk.tensor box per
//     operand on one mbarrier, and each thread adds one 16-byte vector of
//     each. 4 KB of shared memory a block, so the 16 blocks of 128 threads
//     an SM may hold all fit. The output goes out as 16-byte vector stores
//     from registers: a warp's 32 stores fill 512 contiguous bytes (two
//     whole tile rows), so the store path is already coalesced, and a TMA
//     store would add a staging tile and a bulk-group wait.
// copy2h and manual2 keep one z-block's windows a block:
//   - copy2h_ldg_kernel: as copy2's ldg tile, one z-block a block, every
//     plane walked in turn. The window planes that no output reads (a's
//     planes 1..hb-1, all of b's) are loaded with ld.volatile, which the
//     compiler may not delete, so the kernel moves the bytes the JAX tool
//     counts, as csrc/hbm.cu does;
//   - copy2h_tma_kernel: one box per window per operand (6) on one
//     mbarrier whose expected bytes are the full boxes, clipped or not
//     (TMA fills the part outside the array with zeros and counts it);
//     then every thread reads one 16-byte vector a plane;
//   - manual2_kernel (tma only): the block walks `walk` consecutive
//     z-blocks of its tile, two slots of one merged box per operand each,
//     the next z-block's boxes issued before the current one is waited
//     for: the counterpart of the slot/semaphore ring. A __syncthreads at
//     the end of each z-block frees the slot that the next issue
//     overwrites.
// The tensor maps are encoded on the host (fst_dma_encode: the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// link needs no libcuda) once per (pointer, shape, type, box) and kept by
// the wrapper, which passes them to each launch; they go to the kernels as
// __grid_constant__ parameters, so a captured CUDA graph replays them. The
// shared-memory attribute that copy2h's and manual2's boxes need is set
// once per kernel and device. TMA needs 16-byte global strides and a
// 16-byte-aligned base: W a multiple of 4 in f32 and of 8 in bf16; the
// wrapper refuses the rest.
//
// What bounds it on the H100: bytes. It does one to three adds a cell, so
// it times the card's streaming rate for this window pattern and loader;
// the halo planes are re-reads of neighbouring z-blocks, which the 50 MB L2
// may serve. Shared memory per block: copy2 4 KB whatever blk is; 2 x
// (blk + 2hb) planes of 2 KB (copy2h); 2 slots x 2 x (blk + 2hb) (manual2:
// 160 KB at blk 16), under the 227 KB a block may take.
//
// Numerics: each add is one __fadd_rn in f32, rounded to bf16 with
// __float2bfloat16_rn where the type is bf16: torch's own bf16 add (upcast,
// add, round), in the JAX body's order, so bitwise equal to the plain torch
// version (kernels/dma.py).

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kRowBytes = 256;  // a TMA box row: 64 f32 or 128 bf16
constexpr int kRows = 8;        // rows of a TMA tile
constexpr int kPlaneBytes = kRowBytes * kRows;
constexpr int kTmaThreads = kPlaneBytes / 16;  // one 16-byte vector a plane
constexpr int kLdgX = 32, kLdgY = 8;
constexpr int kLdgPlanes = 4;  // planes of an ldg copy2 item
constexpr int kGroup = 1;      // planes of a TMA copy2 item
constexpr int kMaxDevices = 64;
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

// copy2's work items: plane groups of `group` planes of each z-block of
// each (tx x ty) tile, numbered with the tile fastest, then the group, then
// the z-block (kernels/dma.py::copy2_items counts them the same way).
struct Items {
  int D, blk, group, tx, ty, tiles_x, tiles, groups, total;
  __host__ __device__ Items(int D_, int H, int W, int blk_, int group_,
                            int tx_, int ty_)
      : D(D_), blk(blk_), group(group_), tx(tx_), ty(ty_) {
    tiles_x = (W + tx - 1) / tx;
    tiles = tiles_x * ((H + ty - 1) / ty);
    groups = (blk + group - 1) / group;
    total = tiles * ((D + blk - 1) / blk) * groups;
  }
  // item q's tile corner (x0, y0), first plane z0 and planes n (<= 0 for a
  // group past the array's last plane)
  __device__ void at(int q, int& x0, int& y0, int& z0, int& n) const {
    const int tile = q % tiles, zg = q / tiles;
    const int zb = zg / groups, g = zg - zb * groups;
    x0 = (tile % tiles_x) * tx;
    y0 = (tile / tiles_x) * ty;
    z0 = zb * blk + g * group;
    n = min(min(group, blk - g * group), D - z0);
  }
};

// ---- ldg: per-thread vector loads ------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kLdgX* kLdgY)
    copy2_ldg_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ o, int D, int H, int W, int blk) {
  using P = Pack<T, VEC>;
  const Items it(D, H, W, blk, kLdgPlanes, kLdgX * VEC, kLdgY);
  int x0, y0, z0, n;
  it.at(blockIdx.x, x0, y0, z0, n);
  const int x = x0 + threadIdx.x * VEC, y = y0 + threadIdx.y;
  if (x >= W || y >= H || n <= 0) return;
  const long plane = static_cast<long>(H) * W;
  const long off = z0 * plane + static_cast<long>(y) * W + x;
  P va[kLdgPlanes], vb[kLdgPlanes];
#pragma unroll
  for (int p = 0; p < kLdgPlanes; ++p)
    if (p < n) {
      va[p] = *reinterpret_cast<const P*>(a + off + p * plane);
      vb[p] = *reinterpret_cast<const P*>(b + off + p * plane);
    }
#pragma unroll
  for (int p = 0; p < kLdgPlanes; ++p)
    if (p < n)
      *reinterpret_cast<P*>(o + off + p * plane) = add(va[p], vb[p]);
}

// copy2h: one z-block a block, a thread's column of the tile plane by plane
template <typename T, int VEC>
__global__ void __launch_bounds__(kLdgX* kLdgY)
    copy2h_ldg_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ o, int D, int H, int W, int blk,
                      int hb) {
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

  const int zl = window_lo(k, blk, hb), zh = window_hi(k, blk, hb, D);
  for (int w = 0; w < 2; ++w) {
    const int zw = w ? zh : zl;
    const int ze = min(zw + hb, D);
    for (int z = zw; z < ze; ++z) {
      if (z > zw) touch<sizeof(P)>(at(a, z));
      touch<sizeof(P)>(at(b, z));
    }
  }
  const P lohi = add(*at(a, zl), *at(a, zh));
#pragma unroll 4
  for (int z = z0; z < z1; ++z)
    *reinterpret_cast<P*>(o + z * plane + off) =
        add(add(*at(a, z), *at(b, z)), lohi);
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

// copy2: the block's item, a's box at 0 and b's at kBox, kGroup planes each.
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    copy2_tma_kernel(const __grid_constant__ CUtensorMap am,
                     const __grid_constant__ CUtensorMap bm,
                     T* __restrict__ o, int D, int H, int W, int blk) {
  using P = Pack<T, 16 / sizeof(T)>;
  constexpr int kBox = kGroup * kPlaneBytes;
  __shared__ __align__(128) unsigned char sa[2 * kBox];
  __shared__ uint64_t bar;
  const Items it(D, H, W, blk, kGroup, kRowBytes / sizeof(T), kRows);
  int x0, y0, z0, n;
  it.at(blockIdx.x, x0, y0, z0, n);
  if (n <= 0) return;  // a group past the array's last plane
  if (threadIdx.x == 0) {
    bar_init(&bar);
    bar_expect(&bar, 2 * kBox);
    tma_box(sa, &am, x0, y0, z0, &bar);
    tma_box(sa + kBox, &bm, x0, y0, z0, &bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  const TileLane t(x0, y0, H, W, o);
  bar_wait(&bar, 0);
  if (!t.live) return;
  const long plane = static_cast<long>(H) * W;
  T* dst = o + z0 * plane + static_cast<long>(t.y) * W + t.x;
  for (int p = 0; p < n; ++p)
    *reinterpret_cast<P*>(dst + p * plane) =
        add(plane_at<T>(sa, p, t), plane_at<T>(sa + kBox, p, t));
}

// copy2h, one z-block per block. Shared: a_mid, b_mid (blk planes each),
// then a_lo, a_hi, b_lo, b_hi (hb planes each).
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    copy2h_tma_kernel(const __grid_constant__ CUtensorMap am,
                      const __grid_constant__ CUtensorMap ah,
                      const __grid_constant__ CUtensorMap bm,
                      const __grid_constant__ CUtensorMap bh,
                      T* __restrict__ o, int D, int H, int W, int blk,
                      int hb) {
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
    const int hp = hb * kPlaneBytes;
    bar_expect(&bar, (2 * blk + 4 * hb) * kPlaneBytes);
    tma_box(sa, &am, x0, y0, z0, &bar);
    tma_box(sb, &bm, x0, y0, z0, &bar);
    tma_box(halo, &ah, x0, y0, zl, &bar);
    tma_box(halo + hp, &ah, x0, y0, zh, &bar);
    tma_box(halo + 2 * hp, &bh, x0, y0, zl, &bar);
    tma_box(halo + 3 * hp, &bh, x0, y0, zh, &bar);
  }
  bar_wait(&bar, 0);
  const TileLane t(x0, y0, H, W, o);
  if (!t.live) return;
  const P lohi = add(plane_at<T>(halo, 0, t), plane_at<T>(halo, hb, t));
  const long plane = static_cast<long>(H) * W;
  const int n = min(blk, D - z0);
  for (int p = 0; p < n; ++p)
    *reinterpret_cast<P*>(o + (z0 + p) * plane + static_cast<long>(t.y) * W +
                          t.x) =
        add(add(plane_at<T>(sa, p, t), plane_at<T>(sb, p, t)), lohi);
}

// manual2: the block walks z-blocks [kb, kb + walk) of its tile; slot s
// holds a's and b's merged (blk + 2hb)-plane boxes.
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    manual2_kernel(const __grid_constant__ CUtensorMap ae,
                   const __grid_constant__ CUtensorMap be, T* __restrict__ o,
                   int D, int H, int W, int blk, int hb, int walk) {
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

// Dynamic shared memory of a block, alignment slack included (copy2's
// two boxes are static).
int copy2h_tma_smem(int blk, int hb) {
  return (2 * blk + 4 * hb) * kPlaneBytes + 128;
}
int manual2_smem(int blk, int hb) {
  return 4 * (blk + 2 * hb) * kPlaneBytes + 128;
}

// Lets `Kernel` take up to kMaxSmem of dynamic shared memory (over the 48
// KB a launch gets by default), once per kernel and device; 0 or a CUDA
// error code.
template <auto Kernel>
int allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(Kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return static_cast<int>(e);
}

// copy2's work items on a (D, H, W) array of `es`-byte elements: the
// blocks of its grid
int copy2_items(int D, int H, int W, int blk, int tma, int vec, int es) {
  return tma ? Items(D, H, W, blk, kGroup, kRowBytes / es, kRows).total
             : Items(D, H, W, blk, kLdgPlanes, kLdgX * vec, kLdgY).total;
}

CUtensorMap map_from(const void* p) {
  CUtensorMap m;
  memcpy(&m, p, sizeof m);
  return m;
}

template <typename T>
int launch(const void* a, const void* b, void* o, const void* const* maps,
           int D, int H, int W, int form, int tma, int blk, int hb, int walk,
           int vec, int grid, cudaStream_t s) {
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ot = static_cast<T*>(o);
  constexpr int V = 16 / sizeof(T);
  if (!tma) {
    const dim3 block(kLdgX, kLdgY);
    if (form == kCopy2) {
      if (vec == V)
        copy2_ldg_kernel<T, V><<<grid, block, 0, s>>>(at, bt, ot, D, H, W,
                                                      blk);
      else
        copy2_ldg_kernel<T, 1><<<grid, block, 0, s>>>(at, bt, ot, D, H, W,
                                                      blk);
      return fst::launch_status();
    }
    const int cols = vec == V ? W / V : W;
    const dim3 g(fst::cdiv(cols, kLdgX), fst::cdiv(H, kLdgY),
                 fst::cdiv(D, blk));
    if (vec == V)
      copy2h_ldg_kernel<T, V><<<g, block, 0, s>>>(at, bt, ot, D, H, W, blk,
                                                  hb);
    else
      copy2h_ldg_kernel<T, 1><<<g, block, 0, s>>>(at, bt, ot, D, H, W, blk,
                                                  hb);
    return fst::launch_status();
  }
  const int tx = kRowBytes / sizeof(T);
  const CUtensorMap am = map_from(maps[0]), bm = map_from(maps[2]);
  int rc = 0;
  if (form == kCopy2) {
    copy2_tma_kernel<T><<<grid, kTmaThreads, 0, s>>>(am, bm, ot, D, H, W,
                                                     blk);
  } else if (form == kCopy2h) {
    const CUtensorMap ah = map_from(maps[1]), bh = map_from(maps[3]);
    if ((rc = allow_smem<copy2h_tma_kernel<T>>())) return rc;
    const dim3 g(fst::cdiv(W, tx), fst::cdiv(H, kRows), fst::cdiv(D, blk));
    copy2h_tma_kernel<T><<<g, kTmaThreads, copy2h_tma_smem(blk, hb), s>>>(
        am, ah, bm, bh, ot, D, H, W, blk, hb);
  } else {
    if ((rc = allow_smem<manual2_kernel<T>>())) return rc;
    const dim3 g(fst::cdiv(W, tx), fst::cdiv(H, kRows),
                 fst::cdiv(D / blk, walk));
    manual2_kernel<T><<<g, kTmaThreads, manual2_smem(blk, hb), s>>>(
        am, bm, ot, D, H, W, blk, hb, walk);
  }
  return fst::launch_status();
}

}  // namespace

extern "C" {

// A 3-D tensor map of the (D, H, W) array at `base` (bf16 or f32), boxes of
// `planes` x 8 rows x 256 bytes, into the sizeof(CUtensorMap) = 128 bytes
// at `map`; 0 or a CUDA error code.
int fst_dma_encode(void* map, const void* base, int bf16, int D, int H,
                   int W, int planes) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = bf16 ? 2 : 4;
  if (D < 1 || H < 1 || W < 1 || planes < 1 || planes > 256 ||
      W * es % 16 || reinterpret_cast<uintptr_t>(base) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[2] = {W * es, static_cast<cuuint64_t>(H) * W * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / es), kRows,
                             static_cast<cuuint32_t>(planes)};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUtensorMap m;
  const CUresult r =
      fn(&m,
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
  memcpy(map, &m, sizeof m);
  return 0;
}

// o = the form's stream of a and b over z-blocks of blk planes: form 0
// copy2, 1 copy2h (halo windows of hb planes, hb dividing blk), 2 manual2
// (TMA only, D % blk == 0, D >= blk + 2hb, `walk` z-blocks a block). `tma`
// picks the loader; vec is the ldg loader's elements per thread (16 bytes'
// worth or 1). With TMA, maps[0..3] are fst_dma_encode's maps of a's mid
// window, a's halo window, b's mid and b's halo (boxes of kGroup planes for
// copy2, blk and hb for copy2h, blk + 2hb for manual2; the halo ones only
// for copy2h). `grid`: copy2's blocks, one a work item (Items::total).
// bf16 selects the element type (else f32). Refuses other combinations
// with cudaErrorInvalidValue.
int fst_dma_stream(const void* a, const void* b, void* o, const void* am,
                   const void* ah, const void* bm, const void* bh, int D,
                   int H, int W, int bf16, int form, int tma, int blk, int hb,
                   int walk, int vec, int grid, void* stream) {
  const int es = bf16 ? 2 : 4;
  const int E = blk + 2 * hb;
  const void* const maps[4] = {am, ah, bm, bh};
  if (D < 1 || H < 1 || W < 1 || blk < 1 || form < kCopy2 ||
      form > kManual2 || (form != kCopy2 && (hb < 1 || blk % hb)) ||
      (form == kManual2 && (!tma || D % blk || D < E || walk < 1)) ||
      (tma && (W * es % 16 || !am || !bm ||
               (form == kCopy2h && (!ah || !bh)) ||
               (form == kCopy2h && copy2h_tma_smem(blk, hb) > kMaxSmem) ||
               (form == kManual2 && manual2_smem(blk, hb) > kMaxSmem))) ||
      (!tma && vec != 1 && vec != 16 / es) || (!tma && vec > 1 && W % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == kCopy2 && grid != copy2_items(D, H, W, blk, tma, vec, es))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, b, o, maps, D, H, W, form, tma, blk,
                                      hb, walk, vec, grid, s)
              : launch<float>(a, b, o, maps, D, H, W, form, tma, blk, hb,
                              walk, vec, grid, s);
}

}  // extern "C"
