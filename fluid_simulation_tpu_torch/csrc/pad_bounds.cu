// Rebuild padded, boundary-conditioned fields from advected interiors.
//
// Replaces fluid_simulation_tpu/kernels/bounds_pallas.py::pallas_pad_bounds
// (_make_kernel) and pallas_pad_bounds_stream: the tail of each split
// advection and of each streamed projection. For B stacked fields it writes
// every element of the (B, D+2, H+2, W+2) output (from torch.empty):
//   - interior cell: the interior sample;
//   - ghost face cell (exactly one ghost coordinate): the signed mirror of
//     the interior edge beside it (signs per field tag b; x+ is always a
//     plain outflow copy) — what setBounds writes on a zero-padded field;
//   - ghost edge or corner (two or more ghost coordinates): zero.
//
// Obstacle scenes (fst_pad_bounds_masked). Replaces pallas_pad_bounds with
// fluid_i/keep_i (bounds_pallas.py:11-16, _make_kernel :55), ROADMAP B7:
// the interior is (smp*fluid_i)*keep_i, and each face mirrors the pre-keep
// edge smp*fluid_i (set_bounds writes the faces before its keep multiply).
// Both masks are interior-shaped views with their own z/y strides.
//
// Design: row work items. A warp owns one padded (z, y) row of every field
// of the stack, and a block kRows consecutive rows of one z plane, so the
// block and warp indices give z and y and the lanes give x: no division per
// element, 32-bit index arithmetic within a row, 64-bit only for the row
// bases. A lane carries P interior x positions 32 apart (every warp access
// is coalesced) and issues all of a chunk's loads — each field, and in the
// masked form fluid_i and keep_i once for all fields — before its first
// store, so an SM holds enough bytes in flight for HBM. P follows the
// row's width: the least of 4, 8 and 16 whose chunk (32 P positions)
// covers W, so a row up to 512 wide is one chunk and a narrow row idles
// few lanes. An interior
// row writes its own x ghosts: the lane that holds x = 0 writes the mirror
// before it, the lane that holds x = W-1 the copy after it. A face row
// (y or z ghost) reads the interior edge row beside it, which its neighbour
// row has just brought into L2, and keep not at all; an edge row (y and z
// ghost) reads nothing. Every access is 32-bit: a padded row of W+2 floats
// is only 8-byte aligned, an interior view of a padded mask only 4-byte.
//
// What bounds it on the H100: memory traffic — the interiors and, masked,
// both masks read once, the padded fields written once; no arithmetic
// beyond a sign and the mask products. One call over three fields at
// 512x256x256 moves 813.22 MB (masked 1,081.66 MB): 0.2428 ms (0.3229 ms)
// at 3.35 TB/s. On an H100 SXM at 700 W such a call takes 0.275 ms (masked
// 0.355), 88 % (91 %) of that bound (PERF.md, K7).
//
// Numerics: a sign multiply is exact and the mask products are rounded in
// the plain order, (smp*fl)*keep, so the result equals the plain torch
// concat form (kernels/bounds.py::pad_bounds_plain) bit for bit.

#include "common.cuh"

namespace {

constexpr int kRows = 4;   // padded rows a block, one warp each

// G: fields held in registers at once (the stack is walked G at a time, the
// masks loaded once a chunk for all of them). P: interior x positions a
// lane carries in a chunk. kMasked: the interior is (smp*fl)*keep and the
// faces mirror smp*fl.
template <int G, int P, bool kMasked>
__global__ void __launch_bounds__(32 * kRows)
    pad_bounds_kernel(const float* __restrict__ smp, float* __restrict__ out,
                      const float* __restrict__ fl, int fsz, int fsy,
                      const float* __restrict__ keep, int ksz, int ksy, int B,
                      int D, int H, int W, int row_blocks, int neg_mask) {
  const int H2 = H + 2, W2 = W + 2;
  const int z = blockIdx.x / row_blocks;
  const int y = (blockIdx.x - z * row_blocks) * kRows + threadIdx.y;
  if (y >= H2) return;
  const int lane = threadIdx.x;
  const long in_field = static_cast<long>(D) * H * W;
  const long out_field = static_cast<long>(D + 2) * H2 * W2;
  float* const orow = out + (static_cast<long>(z) * H2 + y) * W2;
  const bool gy = y == 0 || y == H + 1;
  const bool gz = z == 0 || z == D + 1;
  if (gy && gz) {   // a row of ghost edges and corners
    for (int b = 0; b < B; ++b)
      for (int x = lane; x < W2; x += 32) orow[b * out_field + x] = 0.0f;
    return;
  }
  const bool face = gy || gz;
  const int axis = gz ? 2 : 1;   // the axis a face row mirrors along
  const int zi = z == 0 ? 0 : (z == D + 1 ? D - 1 : z - 1);
  const int yi = y == 0 ? 0 : (y == H + 1 ? H - 1 : y - 1);
  const float* const srow = smp + (static_cast<long>(zi) * H + yi) * W;
  const float* const frow =
      kMasked ? fl + static_cast<long>(zi) * fsz + static_cast<long>(yi) * fsy
              : nullptr;
  const float* const krow =
      kMasked ? keep + static_cast<long>(zi) * ksz + static_cast<long>(yi) * ksy
              : nullptr;
  if (face && lane == 0) {   // a face row's x ghosts are edges
    for (int b = 0; b < B; ++b) {
      orow[b * out_field] = 0.0f;
      orow[b * out_field + W + 1] = 0.0f;
    }
  }
  for (int x0 = lane; x0 < W; x0 += 32 * P) {
    float f[P], k[P];
    if (kMasked) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int x = x0 + 32 * j;
        f[j] = x < W ? frow[x] : 0.0f;
        k[j] = x < W && !face ? krow[x] : 0.0f;
      }
    }
    for (int b0 = 0; b0 < B; b0 += G) {
      float v[G][P];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int x = x0 + 32 * j;
          v[g][j] = b0 + g < B && x < W ? srow[(b0 + g) * in_field + x] : 0.0f;
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int b = b0 + g;
        if (b >= B) break;
        float* const o = orow + b * out_field + 1;   // o[x]: padded x + 1
        const float sx = fst::face_sign(neg_mask, b, 0);
        const float sf = fst::face_sign(neg_mask, b, axis);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int x = x0 + 32 * j;
          if (x >= W) continue;
          const float u = kMasked ? __fmul_rn(v[g][j], f[j]) : v[g][j];
          if (face) {
            o[x] = __fmul_rn(sf, u);
            continue;
          }
          o[x] = kMasked ? __fmul_rn(u, k[j]) : u;
          if (x == 0) o[-1] = __fmul_rn(sx, u);
          if (x == W - 1) o[W] = u;
        }
      }
    }
  }
}

template <int G, int P, bool kMasked>
void run(unsigned blocks, cudaStream_t s, const float* smp, float* out,
         const float* fl, int fsz, int fsy, const float* keep, int ksz,
         int ksy, int B, int D, int H, int W, int row_blocks, int neg_mask) {
  pad_bounds_kernel<G, P, kMasked><<<blocks, dim3(32, kRows), 0, s>>>(
      smp, out, fl, fsz, fsy, keep, ksz, ksy, B, D, H, W, row_blocks,
      neg_mask);
}

template <bool kMasked>
int launch(const void* smp, void* out, const void* fl, int fsz, int fsy,
           const void* keep, int ksz, int ksy, int B, int D, int H, int W,
           int neg_mask, void* stream) {
  using Run = void (*)(unsigned, cudaStream_t, const float*, float*,
                       const float*, int, int, const float*, int, int, int,
                       int, int, int, int, int);
  // [P: 4, 8, 16][G: 1, 2, 3]
  static constexpr Run kRun[3][3] = {
      {run<1, 4, kMasked>, run<2, 4, kMasked>, run<3, 4, kMasked>},
      {run<1, 8, kMasked>, run<2, 8, kMasked>, run<3, 8, kMasked>},
      {run<1, 16, kMasked>, run<2, 16, kMasked>, run<3, 16, kMasked>}};
  const int p = W <= 32 * 4 ? 0 : (W <= 32 * 8 ? 1 : 2);
  const int g = B < 3 ? B - 1 : 2;
  const int row_blocks = static_cast<int>(fst::cdiv(H + 2, kRows));
  kRun[p][g](static_cast<unsigned>(D + 2) * row_blocks,
             static_cast<cudaStream_t>(stream), static_cast<const float*>(smp),
             static_cast<float*>(out), static_cast<const float*>(fl), fsz, fsy,
             static_cast<const float*>(keep), ksz, ksy, B, D, H, W, row_blocks,
             neg_mask);
  return fst::launch_status();
}

}  // namespace

extern "C" {

// smp: (B, D, H, W) interiors; out: (B, D+2, H+2, W+2) padded fields.
int fst_pad_bounds(const void* smp, void* out, int B, int D, int H, int W,
                   int neg_mask, void* stream) {
  return launch<false>(smp, out, nullptr, 0, 0, nullptr, 0, 0, B, D, H, W,
                       neg_mask, stream);
}

// The obstacle form; fl and keep are interior (D, H, W) views with z/y
// strides fsz/fsy and ksz/ksy.
int fst_pad_bounds_masked(const void* smp, void* out, const void* fl, int fsz,
                          int fsy, const void* keep, int ksz, int ksy, int B,
                          int D, int H, int W, int neg_mask, void* stream) {
  return launch<true>(smp, out, fl, fsz, fsy, keep, ksz, ksy, B, D, H, W,
                      neg_mask, stream);
}

}  // extern "C"
