// Trilinear sample of a padded field at backtraced coordinates: the corner
// fetch and the lerp of compat and fast advection in one launch.
//
// Replaces fluid_simulation_tpu/kernels/advect_compat.py::corner_fetch,
// reached through trilinear_gather_pallas (ROADMAP B19). That TPU kernel
// fetches the 8 trilinear corners of `prev` with row shifts and <=128-lane
// gathers inside a window of +-K z/y offsets, because a VMEM block holds
// only a few z-slabs; the lerp (_lerp8) runs outside it in XLA, and a
// uniform lax.cond falls back to the XLA gather whenever a backtrace leaves
// the window. Its value does not depend on K (the fallback is exact). A
// CUDA thread reads any address, so this kernel has no window: it is exact
// for every backtrace, and it computes what trilinear_gather_pallas returns,
// the corners and the lerp together.
//
// Per interior cell, from its coordinates (xb, yb, zb) (padded-index units,
// clamped by the caller to [0.5, N+0.5] as simulation.cpp:388-390 does):
//   i0/j0/k0 = floor, sx/sy/sz = coordinate - floor,
//   base = k0*sz + j0*sy + i0, clamped as ops/advect.py::trilinear_gather
//   clamps it, so that raw coordinates read inside the array too;
//   the corners base + {0, 1, sy, sy+1, sz, sz+1, sz+sy, sz+sy+1};
//   the lerp in _lerp8's order: x, then y, then z.
//
// What bounds it on the H100: memory traffic. It reads three coordinates
// and writes one value per cell (coalesced); the eight corners of a cell
// lie in two rows of two planes, which neighbouring threads share, so at
// 128x64x64 `prev` (2.27 MB) is read from L2 after the first touch.
//
// Numerics: every product and difference is rounded on its own
// (__fmul_rn/__fsub_rn/__fadd_rn, -fmad=false), in the plain torch
// expression's order, so the result equals the plain gather bit for bit.
// Indices are 64-bit: 512x256x256 padded has more than 2^25 elements.

#include "common.cuh"

namespace {

__global__ void trilinear_gather_kernel(const float* __restrict__ prev,
                                        const float* __restrict__ xb,
                                        const float* __restrict__ yb,
                                        const float* __restrict__ zb,
                                        float* __restrict__ out, int D, int H,
                                        int W) {
  const long n = static_cast<long>(D) * H * W;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float x = xb[idx], y = yb[idx], z = zb[idx];
  const long i0 = static_cast<long>(floorf(x));
  const long j0 = static_cast<long>(floorf(y));
  const long k0 = static_cast<long>(floorf(z));
  const float sx = __fsub_rn(x, static_cast<float>(i0));
  const float sy = __fsub_rn(y, static_cast<float>(j0));
  const float sz = __fsub_rn(z, static_cast<float>(k0));

  const long py = W + 2;
  const long pz = static_cast<long>(H + 2) * (W + 2);
  const long last = static_cast<long>(D + 2) * pz - 1 - (pz + py + 1);
  long base = k0 * pz + j0 * py + i0;
  base = base < 0 ? 0 : (base > last ? last : base);
  const float* c = prev + base;

  const float c00 = fst::lerp_rn(c[0], c[1], sx);
  const float c01 = fst::lerp_rn(c[pz], c[pz + 1], sx);
  const float c10 = fst::lerp_rn(c[py], c[py + 1], sx);
  const float c11 = fst::lerp_rn(c[pz + py], c[pz + py + 1], sx);
  const float c0 = fst::lerp_rn(c00, c10, sy);
  const float c1 = fst::lerp_rn(c01, c11, sy);
  out[idx] = fst::lerp_rn(c0, c1, sz);
}

}  // namespace

extern "C" {

// out (D, H, W) = trilinear sample of padded prev (D+2, H+2, W+2) at the
// interior-shaped coordinates xb, yb, zb; all contiguous float32.
int fst_trilinear_gather(const void* prev, const void* xb, const void* yb,
                         const void* zb, void* out, int D, int H, int W,
                         void* stream) {
  const long n = static_cast<long>(D) * H * W;
  const int block = 256;
  trilinear_gather_kernel<<<fst::cdiv(n, block), block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(xb),
      static_cast<const float*>(yb), static_cast<const float*>(zb),
      static_cast<float*>(out), D, H, W);
  return fst::launch_status();
}

}  // extern "C"
