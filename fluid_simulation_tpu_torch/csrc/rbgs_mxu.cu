// The tensor-core probe's half-sweep: one red or black half-sweep of the
// empty-scene, b = 0 RBGS solve with the x-neighbour pair taken from an FP64
// tensor-core product, in place on a padded (D+2, H+2, W+2) f32 field.
//
// Replaces tools/exp_solve_mxu.py::make_mxu_solve (:31, pallas_call :92),
// ROADMAP B23. That kernel moved the x pair f[x-1] + f[x+1] of every cell
// onto the TPU's matrix unit as one banded product
//   xs = f.reshape(D2*H2, W2) @ Bx,  Bx[w', k] = (w' == k) | (w' == k + 2),
// so that the stencil's lane shifts, which Mosaic pays for in relayouts,
// disappear, and the rest of the update stayed on the vector unit; it is
// bitwise to the unpacked solve (pallas_rbgs_solve, packed=False). Here it
// is bitwise to the port's K1 (kernels.linsolve.rbgs_solve(0, ...,
// packed=False), csrc/rbgs.cu), which with no keep is the packed K1.
//
// Format. TF32 keeps 10 mantissa bits, so a TF32 product of f32 values is
// not exact; 3xTF32 (the split into a big and a small TF32 part) is not
// guaranteed bitwise either, because the tensor core adds the partial
// products in its own order and precision. The FP64 tensor cores
// (mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64) are exact here: every
// product is f * 1 or f * 0, and the two non-zero terms add exactly in f64
// (or, with exponents more than 29 apart, their f64 sum rounds to a value
// whose f32 rounding is the larger term, as the f32 sum is), so
// __double2float_rn of the sum equals __fadd_rn(xm, xp).
//
// Fragments (PTX ISA, mma.m8n8k4 .f64): A (8 x 4, row) one value a lane, at
// row lane/4, column lane%4; B (4 x 8, col) one value, at row lane%4,
// column lane/4; C and D (8 x 8) two values, at row lane/4, columns
// 2*(lane%4) + {0, 1}. A warp owns an 8 x 8 output tile: 8 interior rows
// (z, y) of one z plane and 8 interior x from n0. Only the band's non-zero
// K blocks are computed: output column j needs padded columns n0 + j and
// n0 + j + 2, so the 10 columns n0 .. n0 + 9 in 3 k-steps of 4 (the dense
// product at W2 = 130 takes 33). B is a constant of the lane:
// B_s[kk][j] = (4s + kk == j) | (4s + kk == j + 2). The lane's two output
// columns are neighbours, one of each colour, so each lane updates exactly
// the one of the half-sweep's colour: the y and z neighbours and prev from
// memory, ((((xs + y+) + y-) + z+) + z-), and the cell's ghost mirrors, as
// K1's half-sweep does (common.cuh). Cells of the half-sweep's own colour
// that A reads enter with weight 0; the ghost column a cell mirrors is read
// by that cell's own lane before its write.
//
// What bounds it on the H100: memory and latency, as K1 (8 f32 operations a
// cell a sweep; the tensor-core work, 3 x 512 f64 flops a tile a
// half-sweep, is far under the FP64 tensor rate). Hopper has no lane
// relayout for the tensor cores to hide, so no gain over K1 is expected;
// the A loads add three 4-byte reads a lane a half-sweep.
//
// Numerics: as K1, each operation rounded on its own (__fadd_rn,
// __fmul_rn, -fmad=false): bitwise equal to the plain torch version
// (kernels/linsolve_mxu.py) and to K1.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block, one 8 x 8 output tile each
constexpr int kTile = 8;

__global__ void __launch_bounds__(32 * kWarps)
    rbgs_half_mxu_kernel(float* f, const float* __restrict__ prev, int D,
                         int H, int W, float a, float crec, int color) {
  const int lane = threadIdx.x;
  const int kk = lane & 3;  // A column, B row
  const int j = lane >> 2;  // A and D row, B column
  const int n0 = blockIdx.x * kTile;  // interior x index of column 0
  const int y = 1 + (blockIdx.y * kWarps + threadIdx.y) * kTile + j;
  const int z = 1 + blockIdx.z;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const bool row_in = y <= H;
  const float* row = f + z * sz + (row_in ? y : 1) * sy;

  double d0 = 0.0, d1 = 0.0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int col = n0 + 4 * s + kk;  // padded x of the lane's A value
    const double av =
        row_in && col < W + 2 ? static_cast<double>(row[col]) : 0.0;
    const int k = 4 * s + kk;
    const double bv = (k == j || k == j + 2) ? 1.0 : 0.0;
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%4, %5};\n"
        : "=d"(d0), "=d"(d1)
        : "d"(av), "d"(bv), "d"(d0), "d"(d1));
  }

  // the lane's column of the half-sweep's colour: padded z + y + x is even
  // on red (color 0) cells
  const int e = (color + z + y + 1) & 1;
  const int x = n0 + 2 * kk + 1 + e;
  if (!row_in || x > W) return;
  const float xs = __double2float_rn(e ? d1 : d0);
  const long i = z * sz + y * sy + x;
  float sum = __fadd_rn(xs, f[i + sy]);
  sum = __fadd_rn(sum, f[i - sy]);
  sum = __fadd_rn(sum, f[i + sz]);
  sum = __fadd_rn(sum, f[i - sz]);
  const float u = __fmul_rn(__fadd_rn(prev[i], __fmul_rn(a, sum)), crec);
  f[i] = u;
  fst::write_faces(f, i, sy, sz, z, y, x, D, H, W, u, 0, 0);
}

}  // namespace

extern "C" {

// One half-sweep (color 0 red, 1 black) of padded f in place, right-hand
// side prev, b = 0 faces.
int fst_rbgs_half_mxu(void* f, const void* prev, int D, int H, int W,
                      float a, float crec, int color, void* stream) {
  if (D < 1 || H < 1 || W < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(fst::cdiv(W, kTile), fst::cdiv(H, kTile * kWarps), D);
  const dim3 block(32, kWarps);
  rbgs_half_mxu_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(prev), D, H, W, a,
      crec, color);
  return fst::launch_status();
}

}  // extern "C"
