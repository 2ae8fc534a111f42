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

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

inline unsigned cdiv(long n, long d) { return static_cast<unsigned>((n + d - 1) / d); }

}  // namespace fst
