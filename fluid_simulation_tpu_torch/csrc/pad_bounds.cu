// Rebuild padded, boundary-conditioned fields from advected interiors.
//
// Replaces fluid_simulation_tpu/kernels/bounds_pallas.py::pallas_pad_bounds
// (_make_kernel, unmasked), the epilogue of each split advection.
//
// Design. One thread per padded output element, for B stacked fields:
//   - interior cell: the interior sample;
//   - ghost face cell (exactly one ghost coordinate): the signed mirror of
//     the interior edge beside it (signs per field tag b; x+ is always a
//     plain outflow copy) — what setBounds writes on a zero-padded field;
//   - ghost edge or corner (two or more ghost coordinates): zero.
// The output comes from torch.empty, so every element is written here.
//
// What bounds it on the H100: memory traffic, one read of the interiors and
// one write of the padded fields; no arithmetic beyond a sign.
//
// Numerics: a sign multiply is exact, so the result equals the plain torch
// concat form bit for bit.

#include "common.cuh"

namespace {

__global__ void pad_bounds_kernel(const float* __restrict__ smp,
                                  float* __restrict__ out, int B, int D,
                                  int H, int W, int neg_mask) {
  const int W2 = W + 2, H2 = H + 2, D2 = D + 2;
  const long n = static_cast<long>(D2) * H2 * W2;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * B) return;
  const int field = static_cast<int>(idx / n);
  const long j = idx % n;
  const int x = static_cast<int>(j % W2);
  const int y = static_cast<int>((j / W2) % H2);
  const int z = static_cast<int>(j / (static_cast<long>(W2) * H2));

  const bool gx = x == 0 || x == W + 1;
  const bool gy = y == 0 || y == H + 1;
  const bool gz = z == 0 || z == D + 1;
  if (static_cast<int>(gx) + static_cast<int>(gy) + static_cast<int>(gz) > 1) {
    out[idx] = 0.0f;
    return;
  }
  // the interior cell this element copies, clamped onto the nearest edge
  const int xi = x == 0 ? 0 : (x == W + 1 ? W - 1 : x - 1);
  const int yi = y == 0 ? 0 : (y == H + 1 ? H - 1 : y - 1);
  const int zi = z == 0 ? 0 : (z == D + 1 ? D - 1 : z - 1);
  const float v = smp[static_cast<long>(field) * D * H * W
                      + (static_cast<long>(zi) * H + yi) * W + xi];
  float sign = 1.0f;
  if (x == 0) sign = fst::face_sign(neg_mask, field, 0);
  if (gy) sign = fst::face_sign(neg_mask, field, 1);
  if (gz) sign = fst::face_sign(neg_mask, field, 2);
  out[idx] = (gx || gy || gz) ? __fmul_rn(sign, v) : v;
}

}  // namespace

extern "C" {

// smp: (B, D, H, W) interiors; out: (B, D+2, H+2, W+2) padded fields.
int fst_pad_bounds(const void* smp, void* out, int B, int D, int H, int W,
                   int neg_mask, void* stream) {
  const long n = static_cast<long>(B) * (D + 2) * (H + 2) * (W + 2);
  const int block = 256;
  pad_bounds_kernel<<<fst::cdiv(n, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<float*>(out), B, D, H, W,
      neg_mask);
  return fst::launch_status();
}

}  // extern "C"
