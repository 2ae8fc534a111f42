// Vorticity confinement: v += eps*dt*keep*(N x omega) on the interior.
//
// Replaces fluid_simulation_tpu/kernels/vorticity_pallas.py::
// pallas_confinement (_make_confinement_kernel, :46-99), ROADMAP B8, which
// computed the whole update in one pass with the velocities resident in TPU
// on-chip memory. Per interior cell, in ops/vorticity.py's order:
//   omega = curl v with central differences 0.5*(a - b):
//     wx = cy(vz) - cz(vy),  wy = cz(vx) - cx(vz),  wz = cx(vy) - cy(vx);
//   |omega| = sqrt((wx*wx + wy*wy) + wz*wz);
//   g = central gradient of |omega| with a zero ghost shell;
//   norm = sqrt((gx*gx + gy*gy) + gz*gz) + 1e-5;  N = g / norm;
//   f = (eps*dt*keep) * (N x omega);  v + f.
//
// Design. The gradient of |omega| needs |omega| at the six neighbours, and
// each of those needs velocities two cells away; blocks cannot wait for
// each other, so it is two launches. The first writes omega (three interior
// fields) and |omega| into a padded scratch whose ghost shell the wrapper
// zeroed. The second computes N and the update, one thread per padded
// element: a ghost element copies its input, so the outputs come from
// torch.empty and the faces are left as they were, as in the oracle.
//
// What bounds it on the H100: memory traffic. The first launch reads the
// three velocities and writes four scratch fields; the second reads them,
// the velocities and keep, and writes the three outputs. About 60 flops
// per cell (two square roots, three divisions) are far below the f32 rate.
//
// Numerics: every operation is rounded on its own in the plain version's
// order; the square root and the division are spelled __fsqrt_rn and
// __fdiv_rn, IEEE round-to-nearest like torch's, so that no fast-math flag
// can change them. The result equals the plain torch version bit for bit.

#include "common.cuh"

namespace {

__device__ __forceinline__ float central(float p, float m) {
  return __fmul_rn(0.5f, __fsub_rn(p, m));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

// w: (3, D, H, W) interior curl; mag: padded |omega| (ghosts left at zero)
__global__ void curl_kernel(const float* __restrict__ vx,
                            const float* __restrict__ vy,
                            const float* __restrict__ vz,
                            float* __restrict__ w, float* __restrict__ mag,
                            int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (x > W || y > H) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const float wx = __fsub_rn(central(vz[i + sy], vz[i - sy]),
                             central(vy[i + sz], vy[i - sz]));
  const float wy = __fsub_rn(central(vx[i + sz], vx[i - sz]),
                             central(vz[i + 1], vz[i - 1]));
  const float wz = __fsub_rn(central(vy[i + 1], vy[i - 1]),
                             central(vx[i + sy], vx[i - sy]));
  const long n = static_cast<long>(D) * H * W;
  const long m = fst::mask_index(z, y, x, H * W, W);
  w[m] = wx;
  w[n + m] = wy;
  w[2 * n + m] = wz;
  mag[i] = norm3(wx, wy, wz);
}

__global__ void confine_kernel(const float* __restrict__ vx,
                               const float* __restrict__ vy,
                               const float* __restrict__ vz,
                               const float* __restrict__ w,
                               const float* __restrict__ mag,
                               const float* __restrict__ keep, int ksz,
                               int ksy, float* __restrict__ ox,
                               float* __restrict__ oy, float* __restrict__ oz,
                               int D, int H, int W, float s_lit) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x > W + 1 || y > H + 1) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  if (x == 0 || x == W + 1 || y == 0 || y == H + 1 || z == 0 || z == D + 1) {
    ox[i] = vx[i];
    oy[i] = vy[i];
    oz[i] = vz[i];
    return;
  }
  const float gx = central(mag[i + 1], mag[i - 1]);
  const float gy = central(mag[i + sy], mag[i - sy]);
  const float gz = central(mag[i + sz], mag[i - sz]);
  const float norm = __fadd_rn(norm3(gx, gy, gz), 1e-5f);
  const float nx = __fdiv_rn(gx, norm);
  const float ny = __fdiv_rn(gy, norm);
  const float nz = __fdiv_rn(gz, norm);
  const long n = static_cast<long>(D) * H * W;
  const long m = fst::mask_index(z, y, x, H * W, W);
  const float wx = w[m], wy = w[n + m], wz = w[2 * n + m];
  const float s = __fmul_rn(s_lit, keep[fst::mask_index(z, y, x, ksz, ksy)]);
  const float fx = __fmul_rn(s, __fsub_rn(__fmul_rn(ny, wz), __fmul_rn(nz, wy)));
  const float fy = __fmul_rn(s, __fsub_rn(__fmul_rn(nz, wx), __fmul_rn(nx, wz)));
  const float fz = __fmul_rn(s, __fsub_rn(__fmul_rn(nx, wy), __fmul_rn(ny, wx)));
  ox[i] = __fadd_rn(vx[i], fx);
  oy[i] = __fadd_rn(vy[i], fy);
  oz[i] = __fadd_rn(vz[i], fz);
}

}  // namespace

extern "C" {

// curl and |curl| of padded (vx, vy, vz): w (3, D, H, W), mag padded
// (interior written, ghost shell untouched).
int fst_curl(const void* vx, const void* vy, const void* vz, void* w,
             void* mag, int D, int H, int W, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W, block.x), fst::cdiv(H, block.y), D);
  curl_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<float*>(w),
      static_cast<float*>(mag), D, H, W);
  return fst::launch_status();
}

// (ox, oy, oz) = (vx, vy, vz) + s_lit*keep*(N x omega) on the interior, the
// inputs' ghosts elsewhere; keep is an interior view with z/y strides.
int fst_confine(const void* vx, const void* vy, const void* vz, const void* w,
                const void* mag, const void* keep, int ksz, int ksy, void* ox,
                void* oy, void* oz, int D, int H, int W, float s_lit,
                void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv(W + 2, block.x), fst::cdiv(H + 2, block.y),
                  D + 2);
  confine_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(w),
      static_cast<const float*>(mag), static_cast<const float*>(keep), ksz,
      ksy, static_cast<float*>(ox), static_cast<float*>(oy),
      static_cast<float*>(oz), D, H, W, s_lit);
  return fst::launch_status();
}

}  // extern "C"
