// Fast advection's velocity in one launch: the backtrace through the
// projected field, shared by the three components, and the trilinear sample
// of each pre-diffusion save along it, with the (3, D, H, W) stack written
// once.
//
// Fuses what the JAX package's fast step
// (fluid_simulation_tpu/models/windtunnel.py:339-355) computes as the XLA
// backtrace (fluid_simulation_tpu/ops/advect.py::backtrace), three XLA
// gathers at window 0, or K9's corner fetch
// (kernels/advect_compat.py::corner_fetch) with a window, and jnp.stack. The
// plain torch composition is kernels/advect_fast.py::advect_fast_plain.
//
// Per interior cell (z, y, x), padded 1-based coordinates:
//   xb = clamp(x - cx*vx, 0.5, W+0.5), the same for y and z, from the
//   projected velocity at the cell, with cx = float32(dt)*float32(W)
//   computed on the host as backtrace does;
//   floor, the fractions and the corner base once, the base clamped as
//   ops/advect.py::trilinear_gather clamps it;
//   the eight corners of each padded save at that base, lerped x, then y,
//   then z, into out[f, z-1, y-1, x-1] for save f = 0, 1, 2.
// The velocities are the step's interior views of padded fields
// (vx[1:-1, 1:-1, 1:-1]), read in place with the padded strides: a copy to
// contiguous interiors would move 402 MB more at 512x256x256.
//
// Design: row work items, as K19 (csrc/advect_compat.cu). A warp owns one
// interior (z, y) row and a block kRows neighbouring rows of one z plane, so
// z and y come from the block and warp indices (no per-element division),
// and the corner rows and planes a warp reads are the ones its neighbours
// read, shared in L2 (each save at 512x256x256 is 137 MB, beyond the 50 MB
// L2). A lane carries kP x positions 32 apart, so every access to a row is
// coalesced. It issues a chunk's velocity loads, then all 24*kP corner
// loads, then the lerps and the three stores: the coordinates, the base and
// the fractions stay in registers and are computed once for the three
// saves. 64-bit arithmetic only for row bases and the corner base. kP = 2,
// kRows = 4 was the fastest of the forms measured at 512x256x256 (kP 1-4,
// kRows 2-8, with and without streaming cache hints; PERF.md, K20): at
// kP = 4 the 96 corners in flight take 158 registers a thread.
//
// What bounds it on the H100: memory traffic. One call reads the three
// velocity interiors and the three padded saves once and writes the stack:
// 1,215,873,120 B at 512x256x256, 0.3629 ms at 3.35 TB/s. The corner reads
// fall on rows the neighbouring warps bring into L2.
//
// Numerics: every product and difference is rounded on its own
// (fst::back, fst::lerp_rn, -fmad=false) in the plain expression's order,
// and the clamp is min(max(x, lo), hi) as torch.clamp computes it, so the
// result equals the plain composition bit for bit.

#include "common.cuh"

namespace {

constexpr int kRows = 4;   // interior rows a block, one warp each
constexpr int kP = 2;      // x positions a lane carries in a chunk

__global__ void __launch_bounds__(32 * kRows)
    advect_fast_kernel(const float* __restrict__ s0,
                       const float* __restrict__ s1,
                       const float* __restrict__ s2,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ w,
                       float* __restrict__ out, int D, int H, int W,
                       int row_blocks, float cx, float cy, float cz) {
  const int zi = blockIdx.x / row_blocks;
  const int yi = (blockIdx.x - zi * row_blocks) * kRows + threadIdx.y;
  if (yi >= H) return;
  const int lane = threadIdx.x;
  const long py = W + 2;
  const long pz = static_cast<long>(H + 2) * py;
  const long last = static_cast<long>(D + 2) * pz - 1 - (pz + py + 1);
  // the row in the interior views (padded strides, origin at cell (1, 1, 1))
  // and in one field of the stack
  const long vrow = zi * pz + yi * py;
  const long orow = (static_cast<long>(zi) * H + yi) * W;
  const long field = static_cast<long>(D) * H * W;
  const float* const saves[3] = {s0, s1, s2};
  const float hx = static_cast<float>(W) + 0.5f;
  const float hy = static_cast<float>(H) + 0.5f;
  const float hz = static_cast<float>(D) + 0.5f;
  const float fy = static_cast<float>(yi + 1);
  const float fz = static_cast<float>(zi + 1);

  for (int x0 = lane; x0 < W; x0 += 32 * kP) {
    float vu[kP], vv[kP], vw[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int x = x0 + 32 * j;
      const bool ok = x < W;
      vu[j] = ok ? u[vrow + x] : 0.0f;
      vv[j] = ok ? v[vrow + x] : 0.0f;
      vw[j] = ok ? w[vrow + x] : 0.0f;
    }
    long base[kP];
    float tx[kP], ty[kP], tz[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const float xb =
          fst::back(static_cast<float>(x0 + 32 * j + 1), cx, vu[j], hx);
      const float yb = fst::back(fy, cy, vv[j], hy);
      const float zb = fst::back(fz, cz, vw[j], hz);
      const float i0 = floorf(xb), j0 = floorf(yb), k0 = floorf(zb);
      tx[j] = __fsub_rn(xb, i0);
      ty[j] = __fsub_rn(yb, j0);
      tz[j] = __fsub_rn(zb, k0);
      const long b = static_cast<long>(k0) * pz + static_cast<long>(j0) * py +
                     static_cast<long>(i0);
      base[j] = b < 0 ? 0 : (b > last ? last : b);
    }
    // the corners in _lerp8's order: 000, 100, 010, 110, 001, 101, 011, 111
    float c[kP][3][8];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      if (x0 + 32 * j >= W) continue;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const float* p = saves[f] + base[j];
        c[j][f][0] = p[0];
        c[j][f][1] = p[1];
        c[j][f][2] = p[py];
        c[j][f][3] = p[py + 1];
        c[j][f][4] = p[pz];
        c[j][f][5] = p[pz + 1];
        c[j][f][6] = p[pz + py];
        c[j][f][7] = p[pz + py + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int x = x0 + 32 * j;
      if (x >= W) break;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const float* k = c[j][f];
        const float c00 = fst::lerp_rn(k[0], k[1], tx[j]);
        const float c01 = fst::lerp_rn(k[4], k[5], tx[j]);
        const float c10 = fst::lerp_rn(k[2], k[3], tx[j]);
        const float c11 = fst::lerp_rn(k[6], k[7], tx[j]);
        const float c0 = fst::lerp_rn(c00, c10, ty[j]);
        const float c1 = fst::lerp_rn(c01, c11, ty[j]);
        out[f * field + orow + x] = fst::lerp_rn(c0, c1, tz[j]);
      }
    }
  }
}

}  // namespace

extern "C" {

// out (3, D, H, W) = the padded saves s0, s1, s2 (D+2, H+2, W+2), each
// sampled along the backtrace through u, v, w (the x, y, z velocity
// interiors: (D, H, W) views with the padded strides, pointing at cell
// (1, 1, 1)), scales cx, cy, cz; every operand float32, the saves and out
// contiguous.
int fst_advect_fast(const void* s0, const void* s1, const void* s2,
                    const void* u, const void* v, const void* w, void* out,
                    int D, int H, int W, float cx, float cy, float cz,
                    void* stream) {
  const int row_blocks = static_cast<int>(fst::cdiv(H, kRows));
  advect_fast_kernel<<<static_cast<unsigned>(D) * row_blocks,
                       dim3(32, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<float*>(out), D, H, W, row_blocks, cx, cy, cz);
  return fst::launch_status();
}

}  // extern "C"
