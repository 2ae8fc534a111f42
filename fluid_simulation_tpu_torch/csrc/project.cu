// Pressure projection of an empty scene: divergence, then the Poisson
// sweeps (rbgs.cu's half-sweep with a=1, c=6 on a zeroed p), then gradient
// subtraction with the velocity ghost faces fused in.
//
// Replaces fluid_simulation_tpu/kernels/project_pallas.py::pallas_project_empty
// (_make_project_kernel), which ran the whole projection in one kernel with
// the three velocities and p resident in TPU on-chip memory.
//
// Design. Blocks cannot share a field across a grid-wide barrier without a
// cooperative launch, so the projection is 2 + 2*acc launches: divergence,
// the half-sweeps, and gradient-plus-faces. Neighbour validity of an empty
// scene is an in-bounds test, kept as the TPU kernel's selects
// (project_pallas.py:85-96, :138-154): an out-of-bounds neighbour
// contributes 0 to the divergence, and the gradient is central /2h, one-sided
// /h, or 0. p starts at 0 everywhere, ghosts included, so the solve reads
// zero ghosts on its first sweep, like the reference. The velocity faces use
// each component's own signs (project_pallas.py:53-62) and are written by
// the thread that updates the edge cell, as in rbgs.cu.
//
// What bounds it on the H100: memory traffic and launch latency. Divergence
// and gradient each touch the three velocities and p once; at 128x64x64 all
// of it fits the 50 MB L2, and the 32 launches per projection make launch
// overhead a large share.
//
// Numerics: every operation is rounded on its own, in the plain version's
// order, so the result equals the plain torch projection bit for bit.
//
// Obstacle scenes. Replaces project_pallas.py::pallas_project_masked
// (_make_project_masked_kernel, :182-319), ROADMAP B6. Its arithmetic is
// not K2's with a mask, and the plain version (kernels/project.py
// project_masked_plain) keeps its form:
//   - neighbour validity nb = the neighbour's fluid_i times an in-bounds
//     factor, rebuilt here from fluid_i with bounds checks; the divergence
//     is ((((vx+*nb_xp - vx-*nb_xm) + vy+*nb_yp) - vy-*nb_ym) + vz+*nb_zp)
//     - vz-*nb_zm, then (-0.5h * div) * fluid;
//   - the Poisson solve is rbgs.cu's keep form with a=1, c=6 and keep =
//     fluid_i (scalar faces, sign +1), then the deferred red keep multiply;
//   - the gradient is the 0/1 algebra both*central + (mp-both)*fwd +
//     (mm-both)*bwd (ops/project.py:47-60), reading p's ghosts where a
//     mask is 0, as the plain version does;
//   - v - g*fluid, the faces from that pre-keep edge, and only then the
//     interior times keep_vel (set_bounds' order).
// 2 + 2*acc + 1 launches per projection. The masks are interior-shaped
// views with their own z/y strides. Bound as K2, plus one read of fluid_i
// per stencil and of keep_vel per cell.

#include "common.cuh"

namespace {

__global__ void divergence_kernel(const float* __restrict__ vx,
                                  const float* __restrict__ vy,
                                  const float* __restrict__ vz,
                                  float* __restrict__ rhs, int D, int H,
                                  int W, float neg_half_h) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (x > W || y > H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  float d = __fsub_rn(x < W ? vx[i + 1] : 0.0f, x > 1 ? vx[i - 1] : 0.0f);
  d = __fadd_rn(d, y < H ? vy[i + sy] : 0.0f);
  d = __fsub_rn(d, y > 1 ? vy[i - sy] : 0.0f);
  d = __fadd_rn(d, z < D ? vz[i + sz] : 0.0f);
  d = __fsub_rn(d, z > 1 ? vz[i - sz] : 0.0f);
  rhs[i] = __fmul_rn(neg_half_h, d);
}

using fst::gradient;
using fst::gradient_masked;
using fst::nb;

__global__ void grad_faces_kernel(float* vx, float* vy, float* vz,
                                  const float* __restrict__ p, int D, int H,
                                  int W, float inv_h, float inv_2h,
                                  int neg_mask) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (x > W || y > H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const float pi = p[i];
  // out-of-interior neighbours are ghost cells of p: in memory, never used
  const float gx = gradient(x < W, x > 1, p[i + 1], p[i - 1], pi, inv_2h, inv_h);
  const float gy = gradient(y < H, y > 1, p[i + sy], p[i - sy], pi, inv_2h, inv_h);
  const float gz = gradient(z < D, z > 1, p[i + sz], p[i - sz], pi, inv_2h, inv_h);
  const float ux = __fsub_rn(vx[i], gx);
  const float uy = __fsub_rn(vy[i], gy);
  const float uz = __fsub_rn(vz[i], gz);
  vx[i] = ux;
  vy[i] = uy;
  vz[i] = uz;
  fst::write_faces(vx, i, sy, sz, z, y, x, D, H, W, ux, neg_mask, 0);
  fst::write_faces(vy, i, sy, sz, z, y, x, D, H, W, uy, neg_mask, 1);
  fst::write_faces(vz, i, sy, sz, z, y, x, D, H, W, uz, neg_mask, 2);
}

__global__ void divergence_masked_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ fl, int fsz,
    int fsy, float* __restrict__ rhs, int D, int H, int W, float neg_half_h) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (x > W || y > H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const long m = fst::mask_index(z, y, x, fsz, fsy);
  float d = __fsub_rn(__fmul_rn(vx[i + 1], nb(x < W, fl, m + 1)),
                      __fmul_rn(vx[i - 1], nb(x > 1, fl, m - 1)));
  d = __fadd_rn(d, __fmul_rn(vy[i + sy], nb(y < H, fl, m + fsy)));
  d = __fsub_rn(d, __fmul_rn(vy[i - sy], nb(y > 1, fl, m - fsy)));
  d = __fadd_rn(d, __fmul_rn(vz[i + sz], nb(z < D, fl, m + fsz)));
  d = __fsub_rn(d, __fmul_rn(vz[i - sz], nb(z > 1, fl, m - fsz)));
  rhs[i] = __fmul_rn(__fmul_rn(neg_half_h, d), fl[m]);
}

__global__ void grad_faces_masked_kernel(
    float* vx, float* vy, float* vz, const float* __restrict__ p,
    const float* __restrict__ fl, int fsz, int fsy,
    const float* __restrict__ kv, int ksz, int ksy, int D, int H, int W,
    float inv_h, float inv_2h, int neg_mask) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (x > W || y > H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const long m = fst::mask_index(z, y, x, fsz, fsy);
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
  const float k = kv[fst::mask_index(z, y, x, ksz, ksy)];
  const float ux = __fsub_rn(vx[i], __fmul_rn(gx, f));
  const float uy = __fsub_rn(vy[i], __fmul_rn(gy, f));
  const float uz = __fsub_rn(vz[i], __fmul_rn(gz, f));
  vx[i] = __fmul_rn(ux, k);
  vy[i] = __fmul_rn(uy, k);
  vz[i] = __fmul_rn(uz, k);
  // faces mirror the pre-keep edge
  fst::write_faces(vx, i, sy, sz, z, y, x, D, H, W, ux, neg_mask, 0);
  fst::write_faces(vy, i, sy, sz, z, y, x, D, H, W, uy, neg_mask, 1);
  fst::write_faces(vz, i, sy, sz, z, y, x, D, H, W, uz, neg_mask, 2);
}

}  // namespace

extern "C" {

// rhs interior = -0.5*h * divergence of (vx, vy, vz); rhs ghosts untouched.
int fst_divergence(const void* vx, const void* vy, const void* vz, void* rhs,
                   int D, int H, int W, float neg_half_h, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
  divergence_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<float*>(rhs), D, H, W,
      neg_half_h);
  return fst::launch_status();
}

// v -= grad p on the interior of each component, then its ghost faces.
int fst_grad_faces(void* vx, void* vy, void* vz, const void* p, int D, int H,
                   int W, float inv_h, float inv_2h, int neg_mask,
                   void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
  grad_faces_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vx), static_cast<float*>(vy),
      static_cast<float*>(vz), static_cast<const float*>(p), D, H, W, inv_h,
      inv_2h, neg_mask);
  return fst::launch_status();
}

// Obstacle form: rhs interior = (-0.5*h * masked divergence) * fluid_i.
int fst_divergence_masked(const void* vx, const void* vy, const void* vz,
                          const void* fl, int fsz, int fsy, void* rhs, int D,
                          int H, int W, float neg_half_h, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
  divergence_masked_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(fl), fsz, fsy,
      static_cast<float*>(rhs), D, H, W, neg_half_h);
  return fst::launch_status();
}

// Obstacle form: v = (v - grad p * fluid_i) * keep_vel on the interior, the
// faces from the pre-keep edge.
int fst_grad_faces_masked(void* vx, void* vy, void* vz, const void* p,
                          const void* fl, int fsz, int fsy, const void* kv,
                          int ksz, int ksy, int D, int H, int W, float inv_h,
                          float inv_2h, int neg_mask, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
  grad_faces_masked_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vx), static_cast<float*>(vy),
      static_cast<float*>(vz), static_cast<const float*>(p),
      static_cast<const float*>(fl), fsz, fsy, static_cast<const float*>(kv),
      ksz, ksy, D, H, W, inv_h, inv_2h, neg_mask);
  return fst::launch_status();
}

}  // extern "C"
