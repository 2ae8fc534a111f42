// The streamed projection of big grids: the divergence into a packed rhs,
// and the gradient of the packed pressure into packed projected velocities.
// Between them the Poisson solve runs rbgs_stream.cu's passes (b = 0, a = 1,
// c = 6, from fpre = 0), and after them the step's pad_bounds tail rebuilds
// the padded velocities (pad_bounds.cu).
//
// Replaces fluid_simulation_tpu/kernels/project_stream.py, ROADMAP B13/B14:
//   - div_packed<masked>: _div_kernel_maker (empty, in-bounds selects) and
//     _div_masked_kernel_maker with _nb_masks (the neighbour masks rebuilt
//     from fluid_i, the result times fluid_i), stage 1 of
//     pallas_project_stream_packed / _masked;
//   - grad_packed<masked>: _grad_kernel_maker (central / one-sided / zero
//     selects) and _grad_masked_kernel_maker (the 0/1 mask algebra of
//     ops/project.py, v - grad*fluid), stage 3.
// The masked kernel also folds in the solve's final keep multiply
// (project_stream.py:557): p = fpre*fluid_i at every read. Where a
// neighbour lies outside the domain its pressure is the cell's own
// (project_stream.py:420-427 splices the z ends so); its mask is 0, and a
// self neighbour makes the dead term (p - p)*0 a +0 on every axis. The
// empty kernel subtracts the gradient too: with -fmad=false no
// multiply-add can contract across the subtraction, which is why the TPU
// version left it outside its kernel.
//
// Design: one thread per interior cell, (32, 8) blocks over x and y, one
// z row per block row of the grid; nothing is shared between cells, so no
// tiling is needed. Velocities are padded, rhs, p and the output packed,
// masks interior views with their own z/y strides. Offsets are 64-bit.
//
// What bounds it on the H100: memory traffic, as for the resident
// projection's divergence and gradient launches (project.cu): divergence
// reads the three velocities and writes rhs; gradient reads p (and
// fluid_i) and the velocities and writes three packed fields.
//
// Numerics: the operations and their order are project.cu's, each rounded
// on its own: equal to the plain torch versions (kernels/project_stream.py)
// bit for bit.

#include "common.cuh"

namespace {

template <bool MASKED>
__global__ void div_packed_kernel(const float* __restrict__ vx,
                                  const float* __restrict__ vy,
                                  const float* __restrict__ vz,
                                  const float* __restrict__ fl, int fsz,
                                  int fsy, float* __restrict__ rhs, int D,
                                  int H, int W, float neg_half_h) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= W || y >= H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = (z + 1) * sz + (y + 1) * sy + (x + 1);
  const long q = (static_cast<long>(z) * H + y) * W + x;
  const long m = MASKED ? fst::mask_index(z + 1, y + 1, x + 1, fsz, fsy) : 0;
  rhs[q] = fst::divergence_at<MASKED>(vx, vy, vz, fl, m, fsz, fsy, i, sy, sz,
                                      D, H, W, neg_half_h, z + 1, y + 1,
                                      x + 1);
}

// out: (3, D, H, W), the projected interiors of vx, vy, vz
template <bool MASKED>
__global__ void grad_packed_kernel(const float* __restrict__ vx,
                                   const float* __restrict__ vy,
                                   const float* __restrict__ vz,
                                   const float* __restrict__ p,
                                   const float* __restrict__ fl, int fsz,
                                   int fsy, float* __restrict__ out, int D,
                                   int H, int W, float inv_h, float inv_2h) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= W || y >= H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = (z + 1) * sz + (y + 1) * sy + (x + 1);
  const long n = static_cast<long>(D) * H * W;
  const long qy = W, qz = static_cast<long>(H) * W;
  const long q = z * qz + y * qy + x;
  const bool xp = x < W - 1, xm = x > 0, yp = y < H - 1, ym = y > 0,
             zp = z < D - 1, zm = z > 0;
  if (!MASKED) {
    const float pi = p[q];
    const float gx = fst::gradient(xp, xm, xp ? p[q + 1] : pi,
                                   xm ? p[q - 1] : pi, pi, inv_2h, inv_h);
    const float gy = fst::gradient(yp, ym, yp ? p[q + qy] : pi,
                                   ym ? p[q - qy] : pi, pi, inv_2h, inv_h);
    const float gz = fst::gradient(zp, zm, zp ? p[q + qz] : pi,
                                   zm ? p[q - qz] : pi, pi, inv_2h, inv_h);
    out[q] = __fsub_rn(vx[i], gx);
    out[n + q] = __fsub_rn(vy[i], gy);
    out[2 * n + q] = __fsub_rn(vz[i], gz);
    return;
  }
  const long m = fst::mask_index(z + 1, y + 1, x + 1, fsz, fsy);
  const float f = fl[m];
  const float pi = __fmul_rn(p[q], f);
  // the post-keep pressure of a neighbour, or the cell's own outside
  auto pn = [&](bool inside, long dq, long dm) {
    return inside ? __fmul_rn(p[q + dq], fl[m + dm]) : pi;
  };
  const float gx = fst::gradient_masked(
      fst::nb(xp, fl, m + 1), fst::nb(xm, fl, m - 1), pn(xp, 1, 1),
      pn(xm, -1, -1), pi, inv_2h, inv_h);
  const float gy = fst::gradient_masked(
      fst::nb(yp, fl, m + fsy), fst::nb(ym, fl, m - fsy), pn(yp, qy, fsy),
      pn(ym, -qy, -fsy), pi, inv_2h, inv_h);
  const float gz = fst::gradient_masked(
      fst::nb(zp, fl, m + fsz), fst::nb(zm, fl, m - fsz), pn(zp, qz, fsz),
      pn(zm, -qz, -fsz), pi, inv_2h, inv_h);
  out[q] = __fsub_rn(vx[i], __fmul_rn(gx, f));
  out[n + q] = __fsub_rn(vy[i], __fmul_rn(gy, f));
  out[2 * n + q] = __fsub_rn(vz[i], __fmul_rn(gz, f));
}

dim3 cell_grid(int D, int H, int W, dim3 block) {
  return dim3(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
}

}  // namespace

extern "C" {

// rhs (packed) = -0.5h * divergence of the padded (vx, vy, vz); with fl (an
// interior fluid_i view, else nullptr) the obstacle form, times fluid_i.
int fst_div_packed(const void* vx, const void* vy, const void* vz,
                   const void* fl, int fsz, int fsy, void* rhs, int D, int H,
                   int W, float neg_half_h, void* stream) {
  const dim3 block(32, 8, 1);
  const auto kernel =
      fl == nullptr ? div_packed_kernel<false> : div_packed_kernel<true>;
  kernel<<<cell_grid(D, H, W, block), block, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(fl), fsz, fsy,
      static_cast<float*>(rhs), D, H, W, neg_half_h);
  return fst::launch_status();
}

// out (3, D, H, W) = the padded velocities' interiors minus the gradient of
// the packed pressure p; with fl the obstacle form (p = p*fluid_i, v -
// grad*fluid_i).
int fst_grad_packed(const void* vx, const void* vy, const void* vz,
                    const void* p, const void* fl, int fsz, int fsy,
                    void* out, int D, int H, int W, float inv_h, float inv_2h,
                    void* stream) {
  const dim3 block(32, 8, 1);
  const auto kernel =
      fl == nullptr ? grad_packed_kernel<false> : grad_packed_kernel<true>;
  kernel<<<cell_grid(D, H, W, block), block, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(p),
      static_cast<const float*>(fl), fsz, fsy, static_cast<float*>(out), D, H,
      W, inv_h, inv_2h);
  return fst::launch_status();
}

}  // extern "C"
