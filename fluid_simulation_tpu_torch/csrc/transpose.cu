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
//   - strided_copy_kernel: o[i0, i1, i2] = a[i0*s0 + i1*s1 + i2*s2] * scale,
//     output contiguous, one thread per output element (x is contiguous on
//     both sides in every form the probe has). It serves swap01 (a plane
//     permutation, scale 1), strided_row (scale 1) and store_strided (2).
//
// What bounds them on the H100: bytes, one read and one write of each
// element (the transposed reads of a 32 x 32 tile touch 32 rows, 128 bytes
// of each, so no sector is wasted once the tile is whole).
//
// Numerics: a copy, and x * scale rounded once (__fmul_rn): bitwise equal
// to the plain torch versions (kernels/transpose.py).

#include "common.cuh"

namespace {

constexpr int kTile = 32, kRowsPerPass = 8;

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

__global__ void strided_copy_kernel(const float* __restrict__ a,
                                    float* __restrict__ o, int n0, int n1,
                                    int n2, long long s0, long long s1,
                                    long long s2, float scale) {
  const long long n = static_cast<long long>(n0) * n1 * n2;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long i2 = i % n2, i1 = (i / n2) % n1, i0 = i / n2 / n1;
  o[i] = __fmul_rn(a[i0 * s0 + i1 * s1 + i2 * s2], scale);
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

// o (n0, n1, n2), contiguous = a[i0*s0 + i1*s1 + i2*s2] * scale.
int fst_strided_copy(const void* a, void* o, int n0, int n1, int n2,
                     long long s0, long long s1, long long s2, float scale,
                     void* stream) {
  const long long n = static_cast<long long>(n0) * n1 * n2;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 256;
  strided_copy_kernel<<<fst::cdiv(n, block), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(o), n0, n1, n2, s0,
      s1, s2, scale);
  return fst::launch_status();
}

}  // extern "C"
