// Red-black Gauss-Seidel half-sweep with the ghost faces fused in.
//
// Replaces fluid_simulation_tpu/kernels/linsolve_pallas.py::pallas_rbgs_solve
// (packed=True, empty scene: the body _packed_body), which ran all `acc`
// sweeps of f = (prev + a*sum6(f)) * (1/c) with setBounds after each sweep,
// the field resident in TPU on-chip memory. The projection kernel
// (project.cu) reuses this half-sweep for its Poisson solve.
//
// Design. One launch per half-sweep, 2*acc launches per solve, in place on
// the wrapper's own clone of the field: blocks run in no order, so the
// launch boundary is the barrier between the red and the black half. One
// thread per cell of the colour being updated. Red cells are those whose
// padded index sum z+y+x is even (equal to the 1-based interior sum of
// scene/masks.py red_i). The setBounds faces need no launch of their own: a
// ghost face cell is read by exactly one interior cell, its neighbour on the
// edge, so the thread that updates an edge cell writes that cell's mirrors
// right after its update. Sweep 1 therefore still reads the caller's own
// ghost faces, and after the last sweep every face holds the signed mirror
// of the final edge, as setBounds leaves it. Ghost edges and corners are
// never touched.
//
// What bounds it on the H100: memory traffic and launch latency, not
// arithmetic (7 flops per cell). A half-sweep reads the field and prev once
// and writes half the cells; at 128x64x64 the two padded arrays (2 x 2.27 MB)
// sit in the 50 MB L2, so each launch is short and the 30 launches per
// solve make launch overhead a large share of the solve.
//
// Numerics: the neighbour sum is left-associated ((((x+ + x-) + y+) + y-)
// + z+) + z-, and every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, and the library is built with -fmad=false), so the
// result equals the plain torch sweep bit for bit.

#include "common.cuh"

namespace {

__global__ void rbgs_half_kernel(float* f, const float* __restrict__ prev,
                                 int D, int H, int W, float a, float crec,
                                 int color, int neg_mask) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (y > H) return;
  // the colour's cells in this row: z+y+x = color (mod 2)
  const int x = 1 + 2 * t + ((z + y + 1 + color) & 1);
  if (x > W) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;

  float s = __fadd_rn(f[i + 1], f[i - 1]);
  s = __fadd_rn(s, f[i + sy]);
  s = __fadd_rn(s, f[i - sy]);
  s = __fadd_rn(s, f[i + sz]);
  s = __fadd_rn(s, f[i - sz]);
  const float u = __fmul_rn(__fadd_rn(prev[i], __fmul_rn(a, s)), crec);
  f[i] = u;
  fst::write_faces(f, i, sy, sz, z, y, x, D, H, W, u, neg_mask, 0);
}

}  // namespace

extern "C" {

// One half-sweep (color 0 = red, 1 = black) of the padded field f in place.
int fst_rbgs_half(void* f, const void* prev, int D, int H, int W, float a,
                  float crec, int color, int neg_mask, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid(fst::cdiv((W + 1) / 2, block.x), fst::cdiv(H, block.y), D);
  rbgs_half_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(prev), D, H, W, a,
      crec, color, neg_mask);
  return fst::launch_status();
}

const char* fst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
