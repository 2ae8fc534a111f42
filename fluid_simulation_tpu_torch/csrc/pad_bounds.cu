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
//
// Obstacle scenes (fst_pad_bounds_masked). Replaces pallas_pad_bounds with
// fluid_i/keep_i (bounds_pallas.py:11-16, _make_kernel :55), ROADMAP B7:
// the interior is (smp*fluid_i)*keep_i, and each face mirrors the pre-keep
// edge smp*fluid_i (set_bounds writes the faces before its keep multiply).
// Both masks are interior-shaped views with their own z/y strides. Bound:
// the same traffic plus one read of each mask per field.

#include "common.cuh"

namespace {

// fl == nullptr: unmasked; else the interior is (smp*fl)*keep and the faces
// mirror smp*fl
__global__ void pad_bounds_kernel(const float* __restrict__ smp,
                                  float* __restrict__ out,
                                  const float* __restrict__ fl, int fsz,
                                  int fsy, const float* __restrict__ keep,
                                  int ksz, int ksy, int B, int D, int H,
                                  int W, int neg_mask) {
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
  float v = smp[static_cast<long>(field) * D * H * W
                + (static_cast<long>(zi) * H + yi) * W + xi];
  const bool ghost = gx || gy || gz;
  if (fl != nullptr) {
    v = __fmul_rn(v, fl[fst::mask_index(zi + 1, yi + 1, xi + 1, fsz, fsy)]);
    if (!ghost) {
      out[idx] =
          __fmul_rn(v, keep[fst::mask_index(zi + 1, yi + 1, xi + 1, ksz, ksy)]);
      return;
    }
  }
  float sign = 1.0f;
  if (x == 0) sign = fst::face_sign(neg_mask, field, 0);
  if (gy) sign = fst::face_sign(neg_mask, field, 1);
  if (gz) sign = fst::face_sign(neg_mask, field, 2);
  out[idx] = ghost ? __fmul_rn(sign, v) : v;
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
      static_cast<const float*>(smp), static_cast<float*>(out), nullptr, 0, 0,
      nullptr, 0, 0, B, D, H, W, neg_mask);
  return fst::launch_status();
}

// The obstacle form; fl and keep are interior (D, H, W) views with z/y
// strides fsz/fsy and ksz/ksy.
int fst_pad_bounds_masked(const void* smp, void* out, const void* fl, int fsz,
                          int fsy, const void* keep, int ksz, int ksy, int B,
                          int D, int H, int W, int neg_mask, void* stream) {
  const long n = static_cast<long>(B) * (D + 2) * (H + 2) * (W + 2);
  const int block = 256;
  pad_bounds_kernel<<<fst::cdiv(n, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smp), static_cast<float*>(out),
      static_cast<const float*>(fl), fsz, fsy,
      static_cast<const float*>(keep), ksz, ksy, B, D, H, W, neg_mask);
  return fst::launch_status();
}

}  // extern "C"
