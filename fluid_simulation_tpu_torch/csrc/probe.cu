// The launch-overhead probe's tiny kernel: o = x + 1 in one launch.
//
// Replaces the tiny kernel of tools/exp_overhead.py (tiny_kernel, :49-58),
// ROADMAP B23, which copied an (8, 128) f32 tile plus one through VMEM so
// that the probe could time back-to-back kernel calls whose own work is
// nothing. Here it is one thread per element, one block for the probe's
// 1024 elements: what it costs on the card is the launch itself, which is
// what the probe (fluid_simulation_tpu_torch/tools/exp_overhead.py)
// measures, eager and replayed from a CUDA graph.
//
// Beside it, two entry points that launch nothing, with the C signatures of
// fst_probe_add1 and fst_trilinear_gather: the probe's host split times a
// ctypes call through them, so that the call's own cost (ctypes' argument
// conversion and the call) stands apart from the CUDA launch's.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void probe_add1_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = __fadd_rn(x[i], 1.0f);
}

}  // namespace

extern "C" {

// o[i] = x[i] + 1 for the n elements of x.
int fst_probe_add1(const void* x, void* o, int n, void* stream) {
  probe_add1_kernel<<<fst::cdiv(n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return fst::launch_status();
}

// Nothing, with fst_probe_add1's signature.
int fst_probe_noop(const void*, void*, int, void*) { return 0; }

// Nothing, with fst_trilinear_gather's signature.
int fst_probe_noop9(const void*, const void*, const void*, const void*, void*,
                    int, int, int, void*) {
  return 0;
}

}  // extern "C"
