// The degrade variants of K3's stacked x pass on a shared index plane: the
// stacked lerp with its gather replaced one part at a time, so that the
// time each part costs is the difference to `full`.
//
// Replaces the kernel of tools/exp_lerpcost.py (main.make_kernel :29-53,
// ROADMAP B24). The tool patches it over
// advect_pallas._make_lerp_kernel_stack (:55), so it runs inside K3's
// lane_lerp_stack (fluid_simulation_tpu/kernels/advect_pallas.py:154) and
// its pallas_call (:190). Operands: a (Bn, R, C) f32 stack and one (R, Co)
// index plane xb that all Bn fields share; the output is (Bn, R, Co).
// lane_lerp_stack cuts the output columns into chunks of 128 lanes, and
// l = c mod 128 is the lane of column c inside its chunk. For every variant
//   i0 = clip(floor(xb), 0, C-2),  s = xb - i0,  out = a*(1-s) + b*s
// with each product rounded on its own. The variants differ in a and b:
//   full      a = arr[r, i0], b = arr[r, i0+1]: the production pass (its
//             128-lane windows are value-identical to this direct gather)
//   gather1   li = min(i0, 126): a = arr[r, li], b = arr[r, li+1], the
//             first window only; s keeps the unclipped i0
//   nogather  a = b = ((0 + arr[r, off0+l]) + arr[r, off1+l]) + ... over
//             the window offsets (advect_pallas._window_offsets): no gather
//   copy      a = b = arr[r, l]: the DMA alone
//
// On the TPU the variants split the pass between its DMA, its lane gathers
// and its window selects. A CUDA thread loads any lane by address, so
// `full` is two loads a field with no windows; what the variants split on
// the card is the data-dependent loads (full, gather1) against fixed,
// coalesced ones (nogather, copy), and the bytes: copy and gather1 read the
// first 128 lanes of each row, full and nogather all C.
//
// One thread per output (r, c) computes i0 and s once and loops over the Bn
// fields, as K3's lerp_pass_kernel (advect_split.cu) does. It is a kernel
// of its own, not K3's: K3 computes its coordinate from a velocity, this
// one reads it from the index plane, and K3's code is left as it is.
//
// What bounds it on the H100: memory traffic (about 5 flops a field per
// output). At 256^3 `full` moves 478.7 MB: the stack once, the index plane
// once and the output once.
//
// Numerics: every product, sum and difference is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, -fmad=false), in the order of the plain
// torch version (kernels/lerpcost.py), so the two agree bit for bit.

#include "common.cuh"

namespace {

enum Variant { kFull = 0, kGather1 = 1, kNoGather = 2, kCopy = 3 };

template <int V>
__global__ void lerpcost_kernel(const float* __restrict__ arr,
                                const float* __restrict__ xb,
                                float* __restrict__ out, int Bn, int R, int C,
                                int Co) {
  const long n = static_cast<long>(R) * Co;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long r = idx / Co;
  const int l = static_cast<int>(idx - r * Co) & 127;
  const float x = xb[idx];
  const int i0 = min(max(static_cast<int>(floorf(x)), 0), C - 2);
  const float s = __fsub_rn(x, static_cast<float>(i0));
  const float oms = __fsub_rn(1.0f, s);
  const int lo = V == kGather1 ? min(i0, 126) : i0;
  const long field = static_cast<long>(R) * C;

  for (int b = 0; b < Bn; ++b) {
    const float* row = arr + b * field + r * C;
    float a, hi;
    if (V == kFull || V == kGather1) {
      a = row[lo];
      hi = row[lo + 1];
    } else if (V == kNoGather) {
      float acc = 0.0f;
      for (int off = 0;; off += 127) {
        off = min(off, C - 128);
        acc = __fadd_rn(acc, row[off + l]);
        if (off + 126 >= C - 2) break;
      }
      a = hi = acc;
    } else {
      a = hi = row[l];
    }
    out[b * n + idx] = __fadd_rn(__fmul_rn(a, oms), __fmul_rn(hi, s));
  }
}

template <int V>
int launch(const void* arr, const void* xb, void* out, int Bn, int R, int C,
           int Co, void* stream) {
  const long n = static_cast<long>(R) * Co;
  const int block = 256;
  lerpcost_kernel<V><<<fst::cdiv(n, block), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(arr), static_cast<const float*>(xb),
      static_cast<float*>(out), Bn, R, C, Co);
  return fst::launch_status();
}

}  // namespace

extern "C" {

// out (Bn, R, Co) = the stacked lerp of arr (Bn, R, C) at the index plane
// xb (R, Co) with `variant` (0 full, 1 gather1, 2 nogather, 3 copy); all
// contiguous float32. Refuses any other variant with cudaErrorInvalidValue.
int fst_lerpcost_pass(const void* arr, const void* xb, void* out, int Bn,
                      int R, int C, int Co, int variant, void* stream) {
  switch (variant) {
    case kFull:
      return launch<kFull>(arr, xb, out, Bn, R, C, Co, stream);
    case kGather1:
      return launch<kGather1>(arr, xb, out, Bn, R, C, Co, stream);
    case kNoGather:
      return launch<kNoGather>(arr, xb, out, Bn, R, C, Co, stream);
    case kCopy:
      return launch<kCopy>(arr, xb, out, Bn, R, C, Co, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
