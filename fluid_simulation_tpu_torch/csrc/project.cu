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

// One thread per interior cell; the bodies are common.cuh's, shared with
// the cooperative prestep (prestep.cu).
__device__ __forceinline__ bool interior_cell(int W, int H, int& z, int& y,
                                              int& x) {
  x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  z = blockIdx.z + 1;
  return x <= W && y <= H;
}

__global__ void divergence_kernel(const float* __restrict__ vx,
                                  const float* __restrict__ vy,
                                  const float* __restrict__ vz,
                                  float* __restrict__ rhs, int D, int H,
                                  int W, float neg_half_h) {
  int z, y, x;
  if (!interior_cell(W, H, z, y, x)) return;
  fst::divergence_cell(vx, vy, vz, rhs, D, H, W, neg_half_h, z, y, x);
}

__global__ void grad_faces_kernel(float* vx, float* vy, float* vz,
                                  const float* __restrict__ p, int D, int H,
                                  int W, float inv_h, float inv_2h,
                                  int neg_mask) {
  int z, y, x;
  if (!interior_cell(W, H, z, y, x)) return;
  fst::grad_faces_cell(vx, vy, vz, p, D, H, W, inv_h, inv_2h, neg_mask, z, y,
                       x);
}

__global__ void divergence_masked_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ fl, int fsz,
    int fsy, float* __restrict__ rhs, int D, int H, int W, float neg_half_h) {
  int z, y, x;
  if (!interior_cell(W, H, z, y, x)) return;
  fst::divergence_masked_cell(vx, vy, vz, fl, fsz, fsy, rhs, D, H, W,
                              neg_half_h, z, y, x);
}

__global__ void grad_faces_masked_kernel(
    float* vx, float* vy, float* vz, const float* __restrict__ p,
    const float* __restrict__ fl, int fsz, int fsy,
    const float* __restrict__ kv, int ksz, int ksy, int D, int H, int W,
    float inv_h, float inv_2h, int neg_mask) {
  int z, y, x;
  if (!interior_cell(W, H, z, y, x)) return;
  fst::grad_faces_masked_cell(vx, vy, vz, p, fl, fsz, fsy, kv, ksz, ksy, D, H,
                              W, inv_h, inv_2h, neg_mask, z, y, x);
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
