// The launch-overhead probe's tiny kernel: o = x + 1 in one launch.
//
// Replaces the tiny kernel of tools/exp_overhead.py (tiny_kernel, :49-58),
// ROADMAP B23, which copied an (8, 128) f32 tile plus one through VMEM so
// that the probe could time back-to-back kernel calls whose own work is
// nothing. Here it is one thread per element, one block for the probe's
// 1024 elements: what it costs on the card is the launch itself, which is
// what the probe (fluid_simulation_tpu_torch/tools/exp_overhead.py)
// measures, eager and replayed from a CUDA graph.

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

}  // extern "C"
