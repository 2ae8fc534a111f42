// One pass of operator-split semi-Lagrangian advection: a 1-D linear
// interpolation gather along one axis, with the backtrace computed in the
// kernel from the velocity component of that axis.
//
// Replaces fluid_simulation_tpu/kernels/advect_pallas.py::advect_split_t and
// the TPU kernels it launches: the x pass lane_lerp / lane_lerp_stack
// (_lerp_kernel_single, _make_lerp_kernel_nwindow, _make_lerp_kernel_stack),
// the y pass _lerp_pass_yT and the z pass _lerp_pass_zT (_gather_lerp_T).
// Their 128-lane windows, window selects and in-kernel transposes answer TPU
// lane limits only; a CUDA thread gathers along any axis by address. One
// kernel covers all three passes; the wrapper launches it for x, y and z.
//
// Per output cell, for a pass along an axis of interior length N with
// padded coordinate i = out index + 1:
//   xb = clip(i - dtN*v, 0.5, N+0.5);  i0 = floor(xb);  s = xb - i0
//   out = src[i0]*(1-s) + src[i0+1]*s
// dtN = dt*N is rounded to f32 on the host. The Bn stacked fields share the
// coordinate, so it is computed once per cell. The x pass covers every
// (z, y) row including the ghost rows, the y pass every z row including
// ghosts: later passes sample those rows.
//
// What bounds it on the H100: memory traffic. Each output reads one velocity
// and two neighbours per field and writes one value per field; the x-axis
// reads are coalesced, the y and z gathers hit rows that neighbouring
// threads share, and at 128x64x64 the sources fit the 50 MB L2.
//
// Numerics: each product and difference is rounded on its own
// (__fmul_rn/__fsub_rn/__fadd_rn, -fmad=false). A fused multiply-add in the
// backtrace would move xb by an ulp and can flip floor() across a cell; in
// the lerp it would move the result by an ulp. So the result equals the
// plain torch pass bit for bit.

#include "common.cuh"

namespace {

// out: (Bn, O0, O1, O2); src: the same with axis `axis` of length G = N+2;
// vel: padded (V0, V1, V2), read at out index + (off0, off1, off2).
__global__ void lerp_pass_kernel(const float* __restrict__ src,
                                 const float* __restrict__ vel,
                                 float* __restrict__ out, int Bn, int O0,
                                 int O1, int O2, int axis, int G, int V1,
                                 int V2, int off0, int off1, int off2,
                                 float dtN, float hi) {
  const long n = static_cast<long>(O0) * O1 * O2;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int o2 = static_cast<int>(idx % O2);
  const int o1 = static_cast<int>((idx / O2) % O1);
  const int o0 = static_cast<int>(idx / (static_cast<long>(O2) * O1));

  const float v = vel[(static_cast<long>(o0 + off0) * V1 + (o1 + off1)) * V2
                      + (o2 + off2)];
  const int oa = axis == 0 ? o0 : (axis == 1 ? o1 : o2);
  float xb = __fsub_rn(static_cast<float>(oa + 1), __fmul_rn(dtN, v));
  xb = fminf(fmaxf(xb, 0.5f), hi);
  const int i0 = static_cast<int>(floorf(xb));
  const float s = __fsub_rn(xb, static_cast<float>(i0));
  const float oms = __fsub_rn(1.0f, s);

  // source dims and the flat index of the lower sample
  const int S1 = axis == 1 ? G : O1;
  const int S2 = axis == 2 ? G : O2;
  const long S0 = axis == 0 ? G : O0;
  const int c0 = axis == 0 ? i0 : o0;
  const int c1 = axis == 1 ? i0 : o1;
  const int c2 = axis == 2 ? i0 : o2;
  const long lo = (static_cast<long>(c0) * S1 + c1) * S2 + c2;
  const long step = axis == 2 ? 1 : (axis == 1 ? S2 : static_cast<long>(S1) * S2);
  const long src_n = S0 * S1 * S2;

  for (int b = 0; b < Bn; ++b) {
    const float* f = src + b * src_n;
    out[b * n + idx] = __fadd_rn(__fmul_rn(f[lo], oms),
                                 __fmul_rn(f[lo + step], s));
  }
}

}  // namespace

extern "C" {

int fst_lerp_pass(const void* src, const void* vel, void* out, int Bn, int O0,
                  int O1, int O2, int axis, int G, int V1, int V2, int off0,
                  int off1, int off2, float dtN, float hi, void* stream) {
  const long n = static_cast<long>(O0) * O1 * O2;
  const int block = 256;
  lerp_pass_kernel<<<fst::cdiv(n, block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(vel),
      static_cast<float*>(out), Bn, O0, O1, O2, axis, G, V1, V2, off0, off1,
      off2, dtN, hi);
  return fst::launch_status();
}

}  // extern "C"
