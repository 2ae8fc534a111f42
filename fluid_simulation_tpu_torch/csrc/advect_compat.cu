// Compat advection (ops/advect.py::advect) for one field in one launch: the
// backtrace, the trilinear sample, the solid mask and setBounds' faces and
// keep multiply, with the padded result written once.
//
// Fuses what the JAX package computes as three stages for one
// advect(b, prev, vx, vy, vz, ...) call: the XLA backtrace
// (fluid_simulation_tpu/ops/advect.py::backtrace), the corner fetch and lerp
// (kernels/advect_compat.py::corner_fetch, K9, or the XLA gather), and XLA's
// setBounds on the zero-padded sample. The plain torch composition is
// kernels/advect_compat.py::advect_compat_plain.
//
// Per interior cell (z, y, x), padded 1-based coordinates:
//   the backtrace velocities at the cell: component b from `prev`, the
//   others from the current fields (the wrapper passes the three pointers);
//   xb = clamp(x - cx*vx, 0.5, W+0.5), the same for y and z, with
//   cx = float32(dt)*float32(W) computed on the host as backtrace does;
//   the eight corners of padded `prev` at floor(xb, yb, zb), the base
//   clamped as trilinear_gather clamps it, lerped x, then y, then z;
//   obstacle scenes: times fluid_i (the pre-keep value u), then times the
//   padded keep mask at the cell.
// Every padded cell is written once, from torch.empty:
//   interior cells as above; each ghost-face cell as sign*u of the interior
//   cell beside it (x+ a plain copy), times the keep mask at the face; ghost
//   edges and corners 0 (setBounds leaves the zero fill there).
//
// Design: row work items. A warp owns one interior (z, y) row and a block
// kRows neighbouring rows of one z plane, so z and y come from the block and
// warp indices (no per-element division), and the corner rows and planes a
// warp reads are the ones its neighbours read, shared in L2 (`prev` at
// 512x256x256 is 137 MB, beyond the 50 MB L2). A lane carries kP x positions
// 32 apart, so every access to a row is coalesced; it issues a chunk's
// velocity and mask loads together, then its 8*kP corner loads, then its
// stores. The warp of row y = 1 also stores the y = 0 face row, of y = H the
// y = H+1 row, of z = 1 and z = D the z faces, and the warps of the four
// corner rows the edge rows; the lanes at x = 1 and x = W store the x
// ghosts. 64-bit arithmetic only for row bases and the corner base.
//
// What bounds it on the H100: memory traffic. One call reads `prev` once,
// the two other velocity interiors (three for density), in obstacle scenes
// fluid_i and the padded keep mask, and writes the padded result: at
// 512x256x256 813.2 MB a velocity call and 947.4 MB a density call, 0.243 /
// 0.283 ms at 3.35 TB/s (windbench/metrics/compat_advect_roofline.py counts
// the same bytes). The corner reads fall on rows the neighbouring warps
// bring into L2.
//
// Numerics: every product and difference is rounded on its own
// (__fmul_rn/__fsub_rn/__fadd_rn, -fmad=false) in the plain expression's
// order, and the clamp is min(max(x, lo), hi) as torch.clamp computes it, so
// the result equals the plain composition bit for bit.

#include "common.cuh"

namespace {

constexpr int kRows = 4;   // interior rows a block, one warp each
constexpr int kP = 4;      // x positions a lane carries in a chunk

// a ghost-face cell: sign*u, times keep there
template <bool kMasked>
__device__ __forceinline__ float face(const float* keep, long i, float sign,
                                      float u) {
  const float m = __fmul_rn(sign, u);
  return kMasked ? __fmul_rn(m, keep[i]) : m;
}

template <bool kMasked>
__global__ void __launch_bounds__(32 * kRows)
    advect_compat_kernel(const float* __restrict__ prev,
                         const float* __restrict__ u,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ fl,
                         const float* __restrict__ keep,
                         float* __restrict__ out, int D, int H, int W,
                         int row_blocks, float cx, float cy, float cz,
                         int neg_mask) {
  const int zi = blockIdx.x / row_blocks;
  const int y = (blockIdx.x - zi * row_blocks) * kRows + threadIdx.y + 1;
  if (y > H) return;
  const int z = zi + 1;
  const int lane = threadIdx.x;
  const long py = W + 2;
  const long pz = static_cast<long>(H + 2) * py;
  const long last = static_cast<long>(D + 2) * pz - 1 - (pz + py + 1);
  const long row = z * pz + y * py;
  const float* const frow =
      kMasked ? fl + (static_cast<long>(zi) * H + (y - 1)) * W : nullptr;
  const float hx = static_cast<float>(W) + 0.5f;
  const float hy = static_cast<float>(H) + 0.5f;
  const float hz = static_cast<float>(D) + 0.5f;
  const float fy = static_cast<float>(y), fz = static_cast<float>(z);
  const float sx = fst::face_sign(neg_mask, 0, 0);
  const float sy = fst::face_sign(neg_mask, 0, 1);
  const float sz = fst::face_sign(neg_mask, 0, 2);
  const bool ylo = y == 1, yhi = y == H, zlo = z == 1, zhi = z == D;

  for (int x0 = 1 + lane; x0 <= W; x0 += 32 * kP) {
    float vu[kP], vv[kP], vw[kP], f[kP], k[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int x = x0 + 32 * j;
      const bool ok = x <= W;
      vu[j] = ok ? u[row + x] : 0.0f;
      vv[j] = ok ? v[row + x] : 0.0f;
      vw[j] = ok ? w[row + x] : 0.0f;
      if (kMasked) {
        f[j] = ok ? frow[x - 1] : 0.0f;
        k[j] = ok ? keep[row + x] : 0.0f;
      }
    }
    float s[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int x = x0 + 32 * j;
      const float xb = fst::back(static_cast<float>(x), cx, vu[j], hx);
      const float yb = fst::back(fy, cy, vv[j], hy);
      const float zb = fst::back(fz, cz, vw[j], hz);
      const float i0 = floorf(xb), j0 = floorf(yb), k0 = floorf(zb);
      const float tx = __fsub_rn(xb, i0);
      const float ty = __fsub_rn(yb, j0);
      const float tz = __fsub_rn(zb, k0);
      long base = static_cast<long>(k0) * pz + static_cast<long>(j0) * py +
                  static_cast<long>(i0);
      base = base < 0 ? 0 : (base > last ? last : base);
      const float* c = prev + base;
      float r = 0.0f;
      if (x <= W) {
        const float c00 = fst::lerp_rn(c[0], c[1], tx);
        const float c01 = fst::lerp_rn(c[pz], c[pz + 1], tx);
        const float c10 = fst::lerp_rn(c[py], c[py + 1], tx);
        const float c11 = fst::lerp_rn(c[pz + py], c[pz + py + 1], tx);
        const float c0 = fst::lerp_rn(c00, c10, ty);
        const float c1 = fst::lerp_rn(c01, c11, ty);
        r = fst::lerp_rn(c0, c1, tz);
      }
      s[j] = kMasked ? __fmul_rn(r, f[j]) : r;
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int x = x0 + 32 * j;
      if (x > W) break;
      const float q = s[j];
      out[row + x] = kMasked ? __fmul_rn(q, k[j]) : q;
      if (x == 1) out[row] = face<kMasked>(keep, row, sx, q);
      if (x == W)
        out[row + W + 1] = kMasked ? __fmul_rn(q, keep[row + W + 1]) : q;
      if (ylo) out[row - py + x] = face<kMasked>(keep, row - py + x, sy, q);
      if (yhi) out[row + py + x] = face<kMasked>(keep, row + py + x, sy, q);
      if (zlo) out[row - pz + x] = face<kMasked>(keep, row - pz + x, sz, q);
      if (zhi) out[row + pz + x] = face<kMasked>(keep, row + pz + x, sz, q);
    }
  }

  // the x ghosts of the face rows this warp stores are edges
  if (lane == 0) {
    if (ylo) out[row - py] = out[row - py + W + 1] = 0.0f;
    if (yhi) out[row + py] = out[row + py + W + 1] = 0.0f;
    if (zlo) out[row - pz] = out[row - pz + W + 1] = 0.0f;
    if (zhi) out[row + pz] = out[row + pz + W + 1] = 0.0f;
  }
  // the four rows of ghost edges and corners along x
  const long edges[4] = {row - pz - py, row - pz + py, row + pz - py,
                         row + pz + py};
  const bool mine[4] = {zlo && ylo, zlo && yhi, zhi && ylo, zhi && yhi};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (mine[e])
      for (int x = lane; x < W + 2; x += 32) out[edges[e] + x] = 0.0f;
}

template <bool kMasked>
int launch(const void* prev, const void* u, const void* v, const void* w,
           const void* fl, const void* keep, void* out, int D, int H, int W,
           float cx, float cy, float cz, int neg_mask, void* stream) {
  const int row_blocks = static_cast<int>(fst::cdiv(H, kRows));
  advect_compat_kernel<kMasked>
      <<<static_cast<unsigned>(D) * row_blocks, dim3(32, kRows), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(prev), static_cast<const float*>(u),
          static_cast<const float*>(v), static_cast<const float*>(w),
          static_cast<const float*>(fl), static_cast<const float*>(keep),
          static_cast<float*>(out), D, H, W, row_blocks, cx, cy, cz,
          neg_mask);
  return fst::launch_status();
}

}  // namespace

extern "C" {

// out (D+2, H+2, W+2) = advect of padded prev through the padded backtrace
// velocities u, v, w (x, y, z components; one of them may be prev), scales
// cx, cy, cz; fl (D, H, W) and keep (D+2, H+2, W+2) both null in an empty
// scene; every operand contiguous float32.
int fst_advect_compat(const void* prev, const void* u, const void* v,
                      const void* w, const void* fl, const void* keep,
                      void* out, int D, int H, int W, float cx, float cy,
                      float cz, int neg_mask, void* stream) {
  if (fl == nullptr)
    return launch<false>(prev, u, v, w, nullptr, nullptr, out, D, H, W, cx,
                         cy, cz, neg_mask, stream);
  return launch<true>(prev, u, v, w, fl, keep, out, D, H, W, cx, cy, cz,
                      neg_mask, stream);
}

}  // extern "C"
