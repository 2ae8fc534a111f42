// The transpose probe's two kernels: a batched 2-D transpose through shared
// memory, and a strided copy with a scale, both f32.
//
// Replaces the kernel bodies of tools/exp_transpose.py (ROADMAP B23), which
// asked whether Mosaic could transpose or re-stride VMEM values in-kernel on
// the TPU, and at what cost:
//   - probe's mk.f (:61, pallas_call :62): o = a.T of an (R, C) array, at 8
//     shapes from (256, 128) to (2048, 128);
//   - probe3's swap01 (:133, :140): (Z, Y, X) -> (Y, Z, X); strided_row
//     (:148, :155): a[:, 3, :]; major_slice_T (:163, :171): a[:, 3, :].T;
//     store_strided (:179, :187): a * 2, stored row by row.
// On Hopper neither is an in-kernel question: a thread addresses any
// element. The two kernels are what a transposing advection pass would
// launch between passes (the boundary rows of the port's probe):
//   - transpose_kernel: o[b, c, r] = a[b*sb + r*sr + c*sc], output
//     contiguous (B, C, R), over any strided 3-D view. A block of 32 x 8
//     threads moves a 32 x 32 tile: reads along c (coalesced where sc = 1)
//     into a 32 x 33 shared tile (one column of padding, so the transposed
//     read of a column hits 32 banks), then writes along r. Ragged tiles
//     (R or C of 258, 130) are masked. It serves probe's transpose and
//     major_slice_T, and the boundary rows' transposes of the advected
//     stack;
//   - the strided copy: o[i0, i1, i2] = a[i0*s0 + i1*s1 + i2*s2] * scale,
//     output contiguous. It serves swap01 (a plane permutation, scale 1),
//     strided_row (scale 1) and store_strided (2). The wrapper
//     (kernels/transpose.py::copy_plan) first merges the view's adjacent
//     dims whose strides chain, so a contiguous view such as
//     store_strided's is one dim and swap01's a.transpose(0, 1) keeps
//     three, then picks one of three kernels and their launch shape:
//       copy_flat4_kernel: one contiguous dim, 16-byte aligned, n % 4 == 0:
//         one float4 a thread, 256-thread blocks, as many as the run needs.
//         A grid-stride loop sized to the card's resident blocks, 1-4
//         float4s a thread, ran slower in tuning: short blocks that the
//         block scheduler hands out as SMs free up keep every SM busy to
//         the end;
//       copy_rows_kernel<float4>: x contiguous (s2 = 1), n2 % 4 == 0, a
//         16-byte-aligned base and row strides a multiple of 4: each
//         (i0, i1) row is a run of n2/4 float4s; threads along x take
//         float4s, threadIdx.y and blockIdx.y take rows, blockIdx.z takes
//         i0, and each thread loads 2 rows before it stores them (1 where
//         that would leave fewer blocks than SMs);
//       copy_rows_kernel<float>: the rest (a ragged or odd-strided x, a
//         misaligned base), the same grid one element a thread.
//     No thread divides: the outer indices come from the grid. Indices are
//     32-bit (the wrapper caps every merged dim at 2^30, so i + 2*step
//     stays an int); the element offsets i0*s0, i1*s1, i2*s2 are 64-bit
//     products, since a view may span more than 2^31 elements.
//
// What bounds them on the H100: bytes, one read and one write of each
// element (the transposed reads of a 32 x 32 tile touch 32 rows, 128 bytes
// of each, so no sector is wasted once the tile is whole). At the probe's
// 2-8 MB shapes a call is a few microseconds, so what is left beside the
// bytes is each thread's instruction count and the loads it has in flight:
// the copies move 16 bytes an instruction where the view allows it.
//
// Numerics: a copy, and x * scale rounded once (__fmul_rn): bitwise equal
// to the plain torch versions (kernels/transpose.py).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 32, kRowsPerPass = 8;
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kTile* kRowsPerPass)
    transpose_kernel(const float* __restrict__ a, float* __restrict__ o,
                     int R, int C, long long sb, long long sr, long long sc) {
  __shared__ float tile[kTile][kTile + 1];
  const long long b = blockIdx.z;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const float* src = a + b * sb;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[j][threadIdx.x] = src[r * sr + c * sc];
  }
  __syncthreads();
  float* dst = o + b * C * R;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int c = c0 + j, r = r0 + threadIdx.x;
    if (c < C && r < R) dst[static_cast<long long>(c) * R + r] =
        tile[threadIdx.x][j];
  }
}

__device__ __forceinline__ float scaled(float v, float s) {
  return __fmul_rn(v, s);
}
__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}

// value j of a row starting at `row`: element j*s2, or float4 j (s2 = 1)
__device__ __forceinline__ float load(const float* row, int j, long long s2,
                                      float*) {
  return row[j * s2];
}
__device__ __forceinline__ float4 load(const float* row, int j, long long,
                                       float4*) {
  return reinterpret_cast<const float4*>(row)[j];
}

// One contiguous dim of n4 float4s, 16-byte aligned: one float4 a thread.
__global__ void __launch_bounds__(kCopyThreads)
    copy_flat4_kernel(const float4* __restrict__ a, float4* __restrict__ o,
                      int n4, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) o[i] = scaled(a[i], scale);
}

// Rows (i0, i1) of `cols` values of T (float: n2 = cols; float4: n2 =
// 4 cols, s2 = 1). Block (bx, by): x along the row, y over rows; the grid's
// y and z stride over i1 and i0, each thread loading kRowsAhead rows before
// it stores them.
template <typename T, int kRowsAhead>
__global__ void __launch_bounds__(kCopyThreads)
    copy_rows_kernel(const float* __restrict__ a, float* __restrict__ o,
                     int n0, int n1, int cols, long long s0, long long s1,
                     long long s2, float scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  constexpr int kw = sizeof(T) / sizeof(float);
  const long long n2 = static_cast<long long>(cols) * kw;
  const int step = blockDim.y * gridDim.y;
  for (int i0 = blockIdx.z; i0 < n0; i0 += gridDim.z) {
    const float* src = a + i0 * s0;
    T* dst = reinterpret_cast<T*>(o + static_cast<long long>(i0) * n1 * n2);
    for (int i1 = blockIdx.y * blockDim.y + threadIdx.y; i1 < n1;
         i1 += kRowsAhead * step) {
      T v[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u)
        if (i1 + u * step < n1)
          v[u] = load(src + (i1 + u * step) * s1, j, s2,
                      static_cast<T*>(nullptr));
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u)
        if (i1 + u * step < n1)
          dst[static_cast<long long>(i1 + u * step) * cols + j] =
              scaled(v[u], scale);
    }
  }
}

template <typename T>
void launch_rows(int ahead, dim3 grid, dim3 block, cudaStream_t s,
                 const float* a, float* o, int n0, int n1, int cols,
                 long long s0, long long s1, long long s2, float scale) {
  if (ahead == 2)
    copy_rows_kernel<T, 2><<<grid, block, 0, s>>>(a, o, n0, n1, cols, s0,
                                                  s1, s2, scale);
  else
    copy_rows_kernel<T, 1><<<grid, block, 0, s>>>(a, o, n0, n1, cols, s0,
                                                  s1, s2, scale);
}

}  // namespace

extern "C" {

// o (B, C, R), contiguous = the transpose of each (R, C) matrix of the view
// a with element strides (sb, sr, sc).
int fst_transpose(const void* a, void* o, int B, int R, int C, long long sb,
                  long long sr, long long sc, void* stream) {
  if (B < 1 || R < 1 || C < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(fst::cdiv(C, kTile), fst::cdiv(R, kTile), B);
  const dim3 block(kTile, kRowsPerPass);
  transpose_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(o), R, C, sb, sr,
      sc);
  return fst::launch_status();
}

// o (n0, n1, n2), contiguous = a[i0*s0 + i1*s1 + i2*s2] * scale, by the
// wrapper's plan: path 0 copy_rows_kernel<float>, 1 copy_rows_kernel<float4>
// (s2 = 1, n2 % 4 == 0, 16-byte-aligned rows), 2 copy_flat4_kernel (n0 =
// n1 = 1, s2 = 1, n2 % 4 == 0, a aligned); block (bx, by), grid (gx, gy,
// gz), `ahead` (1 or 2) rows a rows thread loads at once. Refuses other
// arguments with cudaErrorInvalidValue.
int fst_strided_copy(const void* a, void* o, int n0, int n1, int n2,
                     long long s0, long long s1, long long s2, float scale,
                     int path, int bx, int by, int gx, int gy, int gz,
                     int ahead, void* stream) {
  const bool vec = path != 0;
  if (n0 < 1 || n1 < 1 || n2 < 1 || path < 0 || path > 2 || bx < 1 ||
      by < 1 || bx * by != kCopyThreads || gx < 1 || gy < 1 || gz < 1 ||
      gy > 65535 || gz > 65535 || (ahead != 1 && ahead != 2) ||
      (vec && (s2 != 1 || n2 % 4 || reinterpret_cast<uintptr_t>(a) % 16 ||
               (n0 > 1 && s0 % 4) || (n1 > 1 && s1 % 4))) ||
      (path == 2 && (n0 != 1 || n1 != 1 || by != 1 || gy != 1 || gz != 1 ||
                     static_cast<long long>(gx) * bx * 4 < n2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  auto* of = static_cast<float*>(o);
  const dim3 grid(gx, gy, gz), block(bx, by);
  if (path == 2)
    copy_flat4_kernel<<<gx, bx, 0, s>>>(static_cast<const float4*>(a),
                                        static_cast<float4*>(o), n2 / 4,
                                        scale);
  else if (vec)
    launch_rows<float4>(ahead, grid, block, s, af, of, n0, n1, n2 / 4, s0,
                        s1, s2, scale);
  else
    launch_rows<float>(ahead, grid, block, s, af, of, n0, n1, n2, s0, s1, s2,
                       scale);
  return fst::launch_status();
}

}  // extern "C"
