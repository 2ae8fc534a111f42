// Shared helpers of the wind-tunnel kernels.
//
// Fields are padded (D+2, H+2, W+2) float32 arrays, z-major with x fastest.
// Every C entry point launches on the stream it is given, never
// synchronises, and returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

namespace fst {

// Ghost-face sign of field `field` along `axis` (0 = x, 1 = y, 2 = z),
// packed by the wrapper: bit 3*field+axis set means "mirror negated".
__device__ __forceinline__ float face_sign(int neg_mask, int field, int axis) {
  return ((neg_mask >> (3 * field + axis)) & 1) ? -1.0f : 1.0f;
}

// setBounds faces owned by interior cell (z, y, x) at flat index i, which
// has just been given value u: each ghost face cell is the mirror of
// exactly one edge cell, so the thread that writes the edge cell writes its
// mirrors (x+ is always an outflow copy). Edges and corners are untouched.
__device__ __forceinline__ void write_faces(float* v, long i, long sy, long sz,
                                            int z, int y, int x, int D, int H,
                                            int W, float u, int neg_mask,
                                            int field) {
  if (x == 1) v[i - 1] = __fmul_rn(face_sign(neg_mask, field, 0), u);
  if (x == W) v[i + 1] = u;
  if (y == 1) v[i - sy] = __fmul_rn(face_sign(neg_mask, field, 1), u);
  if (y == H) v[i + sy] = __fmul_rn(face_sign(neg_mask, field, 1), u);
  if (z == 1) v[i - sz] = __fmul_rn(face_sign(neg_mask, field, 2), u);
  if (z == D) v[i + sz] = __fmul_rn(face_sign(neg_mask, field, 2), u);
}

// Flat index of padded interior cell (z, y, x), 1-based, in an
// interior-shaped (D, H, W) mask with z/y strides msz/msy and x stride 1 —
// a contiguous interior array or an interior view of a padded one.
__device__ __forceinline__ long mask_index(int z, int y, int x, int msz,
                                           int msy) {
  return static_cast<long>(z - 1) * msz + static_cast<long>(y - 1) * msy +
         (x - 1);
}

// neighbour validity of the masked projection: fluid_i of the neighbour at
// mask index m, 0 outside the interior
__device__ __forceinline__ float nb(bool inside, const float* fl, long m) {
  return inside ? fl[m] : 0.0f;
}

// Empty-scene gradient: central where both neighbours are in the interior,
// one-sided where one is, zero where none is (simulation.cpp:322-357).
__device__ __forceinline__ float gradient(bool has_p, bool has_m, float pp,
                                          float pm, float pi, float inv_2h,
                                          float inv_h) {
  if (has_p && has_m) return __fmul_rn(__fsub_rn(pp, pm), inv_2h);
  if (has_p) return __fmul_rn(__fsub_rn(pp, pi), inv_h);
  if (has_m) return __fmul_rn(__fsub_rn(pi, pm), inv_h);
  return 0.0f;
}

// Obstacle-scene gradient: ops/project.py::_one_axis_gradient's 0/1 mask
// algebra, operation for operation.
__device__ __forceinline__ float gradient_masked(float mp, float mm, float pp,
                                                 float pm, float pi,
                                                 float inv_2h, float inv_h) {
  const float both = __fmul_rn(mp, mm);
  const float central = __fmul_rn(__fsub_rn(pp, pm), inv_2h);
  const float fwd = __fmul_rn(__fsub_rn(pp, pi), inv_h);
  const float bwd = __fmul_rn(__fsub_rn(pi, pm), inv_h);
  return __fadd_rn(__fadd_rn(__fmul_rn(both, central),
                             __fmul_rn(__fsub_rn(mp, both), fwd)),
                   __fmul_rn(__fsub_rn(mm, both), bwd));
}

// ---- Per-cell bodies of the resident solve and projection. Each is one
// cell's work in one phase; the one-launch-per-phase kernels (rbgs.cu,
// project.cu) and the cooperative prestep (prestep.cu) run the same code in
// the same order, so they agree bit for bit. Pointers to data that the
// prestep writes during its launch are plain, never __restrict__: a load
// through the read-only cache may return a value from before a grid sync.

// x of the colour cell (`color` 0 red, 1 black) with x-pair index t in
// padded row (z, y): padded z+y+x is even on red cells
__device__ __forceinline__ int colour_x(int color, int z, int y, int t) {
  return 1 + 2 * t + ((z + y + 1 + color) & 1);
}

// (prev + a*sum6(f)) * (1/c) at padded index i, the neighbour sum
// left-associated ((((x+ + x-) + y+) + y-) + z+) + z-
__device__ __forceinline__ float rbgs_update(const float* f, const float* prev,
                                             long i, long sy, long sz,
                                             float a, float crec) {
  float s = __fadd_rn(f[i + 1], f[i - 1]);
  s = __fadd_rn(s, f[i + sy]);
  s = __fadd_rn(s, f[i - sy]);
  s = __fadd_rn(s, f[i + sz]);
  s = __fadd_rn(s, f[i - sz]);
  return __fmul_rn(__fadd_rn(prev[i], __fmul_rn(a, s)), crec);
}

// One cell of a packed half-sweep: the update, stored times keep on a black
// cell when keep (an interior view, z/y strides ksz/ksy) is given, then the
// cell's ghost mirrors of the pre-keep value.
__device__ __forceinline__ void rbgs_cell(float* f, const float* prev,
                                          const float* keep, int ksz, int ksy,
                                          int D, int H, int W, float a,
                                          float crec, int color, int neg_mask,
                                          int field, int z, int y, int x) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const float u = rbgs_update(f, prev, i, sy, sz, a, crec);
  f[i] = (keep != nullptr && color == 1)
             ? __fmul_rn(u, keep[mask_index(z, y, x, ksz, ksy)])
             : u;
  write_faces(f, i, sy, sz, z, y, x, D, H, W, u, neg_mask, field);
}

// The deferred keep multiply of red cell (z, y, x) after the last sweep.
__device__ __forceinline__ void keep_red_cell(float* f, const float* keep,
                                              int ksz, int ksy, int H, int W,
                                              int z, int y, int x) {
  const long i = (static_cast<long>(z) * (H + 2) + y) * (W + 2) + x;
  f[i] = __fmul_rn(f[i], keep[mask_index(z, y, x, ksz, ksy)]);
}

// -0.5h times the divergence of the padded (vx, vy, vz) at interior cell
// (z, y, x), 1-based padded coordinates, flat index i (row stride sy, plane
// stride sz). The empty form: an out-of-interior neighbour contributes 0.
// MASKED, the obstacle form: each neighbour weighted by its fluid_i (fl at
// mask index m, strides fsz/fsy; 0 outside the interior), the result times
// the cell's own (ops/project.divergence, operation for operation). The
// resident and streamed projections and the step's stats (stats.cu) all
// take their divergence from here, so they agree bit for bit.
template <bool MASKED>
__device__ __forceinline__ float divergence_at(
    const float* vx, const float* vy, const float* vz, const float* fl,
    long m, int fsz, int fsy, long i, long sy, long sz, int D, int H, int W,
    float neg_half_h, int z, int y, int x) {
  float d;
  if constexpr (!MASKED) {
    d = __fsub_rn(x < W ? vx[i + 1] : 0.0f, x > 1 ? vx[i - 1] : 0.0f);
    d = __fadd_rn(d, y < H ? vy[i + sy] : 0.0f);
    d = __fsub_rn(d, y > 1 ? vy[i - sy] : 0.0f);
    d = __fadd_rn(d, z < D ? vz[i + sz] : 0.0f);
    d = __fsub_rn(d, z > 1 ? vz[i - sz] : 0.0f);
    return __fmul_rn(neg_half_h, d);
  }
  d = __fsub_rn(__fmul_rn(vx[i + 1], nb(x < W, fl, m + 1)),
                __fmul_rn(vx[i - 1], nb(x > 1, fl, m - 1)));
  d = __fadd_rn(d, __fmul_rn(vy[i + sy], nb(y < H, fl, m + fsy)));
  d = __fsub_rn(d, __fmul_rn(vy[i - sy], nb(y > 1, fl, m - fsy)));
  d = __fadd_rn(d, __fmul_rn(vz[i + sz], nb(z < D, fl, m + fsz)));
  d = __fsub_rn(d, __fmul_rn(vz[i - sz], nb(z > 1, fl, m - fsz)));
  return __fmul_rn(__fmul_rn(neg_half_h, d), fl[m]);
}

// rhs interior = -0.5h * divergence at cell (z, y, x), the empty form.
__device__ __forceinline__ void divergence_cell(const float* vx,
                                                const float* vy,
                                                const float* vz, float* rhs,
                                                int D, int H, int W,
                                                float neg_half_h, int z, int y,
                                                int x) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  rhs[i] = divergence_at<false>(vx, vy, vz, nullptr, 0, 0, 0, i, sy, sz, D,
                                H, W, neg_half_h, z, y, x);
}

// The obstacle form.
__device__ __forceinline__ void divergence_masked_cell(
    const float* vx, const float* vy, const float* vz, const float* fl,
    int fsz, int fsy, float* rhs, int D, int H, int W, float neg_half_h,
    int z, int y, int x) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  rhs[i] = divergence_at<true>(vx, vy, vz, fl, mask_index(z, y, x, fsz, fsy),
                               fsz, fsy, i, sy, sz, D, H, W, neg_half_h, z, y,
                               x);
}

// v -= grad p at cell (z, y, x) of each component, then its ghost faces.
__device__ __forceinline__ void grad_faces_cell(float* vx, float* vy,
                                                float* vz, const float* p,
                                                int D, int H, int W,
                                                float inv_h, float inv_2h,
                                                int neg_mask, int z, int y,
                                                int x) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const float pi = p[i];
  // out-of-interior neighbours are ghost cells of p: in memory, never used
  const float gx =
      gradient(x < W, x > 1, p[i + 1], p[i - 1], pi, inv_2h, inv_h);
  const float gy =
      gradient(y < H, y > 1, p[i + sy], p[i - sy], pi, inv_2h, inv_h);
  const float gz =
      gradient(z < D, z > 1, p[i + sz], p[i - sz], pi, inv_2h, inv_h);
  const float ux = __fsub_rn(vx[i], gx);
  const float uy = __fsub_rn(vy[i], gy);
  const float uz = __fsub_rn(vz[i], gz);
  vx[i] = ux;
  vy[i] = uy;
  vz[i] = uz;
  write_faces(vx, i, sy, sz, z, y, x, D, H, W, ux, neg_mask, 0);
  write_faces(vy, i, sy, sz, z, y, x, D, H, W, uy, neg_mask, 1);
  write_faces(vz, i, sy, sz, z, y, x, D, H, W, uz, neg_mask, 2);
}

// The obstacle form: v = (v - grad p * fluid_i) * keep_vel, the faces from
// the pre-keep value.
__device__ __forceinline__ void grad_faces_masked_cell(
    float* vx, float* vy, float* vz, const float* p, const float* fl, int fsz,
    int fsy, const float* kv, int ksz, int ksy, int D, int H, int W,
    float inv_h, float inv_2h, int neg_mask, int z, int y, int x) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const long m = mask_index(z, y, x, fsz, fsy);
  const float pi = p[i];
  const float gx = gradient_masked(nb(x < W, fl, m + 1), nb(x > 1, fl, m - 1),
                                   p[i + 1], p[i - 1], pi, inv_2h, inv_h);
  const float gy = gradient_masked(nb(y < H, fl, m + fsy),
                                   nb(y > 1, fl, m - fsy), p[i + sy],
                                   p[i - sy], pi, inv_2h, inv_h);
  const float gz = gradient_masked(nb(z < D, fl, m + fsz),
                                   nb(z > 1, fl, m - fsz), p[i + sz],
                                   p[i - sz], pi, inv_2h, inv_h);
  const float f = fl[m];
  const float k = kv[mask_index(z, y, x, ksz, ksy)];
  const float ux = __fsub_rn(vx[i], __fmul_rn(gx, f));
  const float uy = __fsub_rn(vy[i], __fmul_rn(gy, f));
  const float uz = __fsub_rn(vz[i], __fmul_rn(gz, f));
  vx[i] = __fmul_rn(ux, k);
  vy[i] = __fmul_rn(uy, k);
  vz[i] = __fmul_rn(uz, k);
  write_faces(vx, i, sy, sz, z, y, x, D, H, W, ux, neg_mask, 0);
  write_faces(vy, i, sy, sz, z, y, x, D, H, W, uy, neg_mask, 1);
  write_faces(vz, i, sy, sz, z, y, x, D, H, W, uz, neg_mask, 2);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

inline unsigned cdiv(long n, long d) { return static_cast<unsigned>((n + d - 1) / d); }

}  // namespace fst
