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
//
// Obstacle scenes (the keep form). Replaces the apply_keep=True branch of
// _packed_body (linsolve_pallas.py:185-274), ROADMAP B5, and is the Poisson
// solve of the masked projection (project.cu). The plain relax multiplies
// by keep after BOTH halves of a sweep (ops/linsolve.py:111-115), so the
// black half reads the red cells' pre-keep values, solid cells included,
// and the ghost faces hold the pre-keep edge. Here:
//   - the red half writes u, and its ghosts sign*u;
//   - the black half writes u*keep, and its ghosts sign*u (pre-keep);
//   - after the last sweep one launch multiplies the red cells by keep.
// A red cell's post-keep value is read by no one: its neighbours are black
// or ghosts, and the next red half overwrites it before any black half
// reads it. So the red multiply is deferred to the end, where it gives the
// plain result. Sweep 1 reads the caller's ghosts and black cells as they
// are, like the plain version. keep is an interior-shaped (D, H, W) view
// with its own z/y strides (x stride 1); it must be 1 on the ghost shell,
// as every keep mask from scene/masks.py is, so ghosts are never
// multiplied. What bounds it: as above, plus one read of keep per black
// cell per half-sweep.

#include "common.cuh"

namespace {

// the colour's cells: padded (z, y, x) with z+y+x = color (mod 2); false
// for threads past the row's end
__device__ __forceinline__ bool colour_cell(int color, int H, int W, int& z,
                                            int& y, int& x) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  z = blockIdx.z + 1;
  if (y > H) return false;
  x = 1 + 2 * t + ((z + y + 1 + color) & 1);
  return x <= W;
}

// keep != nullptr: the keep form (black cells store u*keep)
__global__ void rbgs_half_kernel(float* f, const float* __restrict__ prev,
                                 const float* __restrict__ keep, int ksz,
                                 int ksy, int D, int H, int W, float a,
                                 float crec, int color, int neg_mask) {
  int z, y, x;
  if (!colour_cell(color, H, W, z, y, x)) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;

  float s = __fadd_rn(f[i + 1], f[i - 1]);
  s = __fadd_rn(s, f[i + sy]);
  s = __fadd_rn(s, f[i - sy]);
  s = __fadd_rn(s, f[i + sz]);
  s = __fadd_rn(s, f[i - sz]);
  const float u = __fmul_rn(__fadd_rn(prev[i], __fmul_rn(a, s)), crec);
  f[i] = (keep != nullptr && color == 1)
             ? __fmul_rn(u, keep[fst::mask_index(z, y, x, ksz, ksy)])
             : u;
  fst::write_faces(f, i, sy, sz, z, y, x, D, H, W, u, neg_mask, 0);
}

// the deferred keep multiply of the red cells after the last sweep
__global__ void keep_red_kernel(float* f, const float* __restrict__ keep,
                                int ksz, int ksy, int H, int W) {
  int z, y, x;
  if (!colour_cell(0, H, W, z, y, x)) return;
  const long i = (static_cast<long>(z) * (H + 2) + y) * (W + 2) + x;
  f[i] = __fmul_rn(f[i], keep[fst::mask_index(z, y, x, ksz, ksy)]);
}

dim3 half_grid(int D, int H, int W, dim3 block) {
  return dim3(fst::cdiv((W + 1) / 2, block.x), fst::cdiv(H, block.y), D);
}

}  // namespace

extern "C" {

// One half-sweep (color 0 = red, 1 = black) of the padded field f in place.
int fst_rbgs_half(void* f, const void* prev, int D, int H, int W, float a,
                  float crec, int color, int neg_mask, void* stream) {
  const dim3 block(32, 8, 1);
  rbgs_half_kernel<<<half_grid(D, H, W, block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(prev), nullptr, 0, 0,
      D, H, W, a, crec, color, neg_mask);
  return fst::launch_status();
}

// The keep form of one half-sweep; keep is the interior (D, H, W) view
// with z/y strides ksz/ksy.
int fst_rbgs_half_keep(void* f, const void* prev, const void* keep, int ksz,
                       int ksy, int D, int H, int W, float a, float crec,
                       int color, int neg_mask, void* stream) {
  const dim3 block(32, 8, 1);
  rbgs_half_kernel<<<half_grid(D, H, W, block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(prev),
      static_cast<const float*>(keep), ksz, ksy, D, H, W, a, crec, color,
      neg_mask);
  return fst::launch_status();
}

// f *= keep on the red interior cells (after the last keep half-sweep).
int fst_keep_red(void* f, const void* keep, int ksz, int ksy, int D, int H,
                 int W, void* stream) {
  const dim3 block(32, 8, 1);
  keep_red_kernel<<<half_grid(D, H, W, block), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(keep), ksz, ksy, H,
      W);
  return fst::launch_status();
}

const char* fst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
