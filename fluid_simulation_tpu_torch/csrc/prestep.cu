// The pre-advection block of a step in one cooperative launch: the three
// velocity diffusions (b = 1, 2, 3, each with prev = the component's own
// input) and then the pressure projection, empty or masked.
//
// Replaces tools/prestep_pallas.py::pallas_prestep (_make_prestep_kernel),
// ROADMAP B22a, which ran the reference's step():115-120 block in one TPU
// call with the three velocities resident in VMEM, bitwise equal to the
// separate solve and projection kernels.
//
// Design. On the card that block is K1 x3 + K2 (K1 keep x3 + K6): about 122
// launches at acc = 15, each a short grid-wide phase, so its event time is
// the host's launch rate, not the device's work. Here one persistent grid,
// sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count
// and launched with cudaLaunchCooperativeKernel, walks every phase of that
// chain with a grid-stride loop and a cooperative_groups grid sync wherever
// the chain has a launch boundary:
//   0. outputs = inputs, p = 0 (the wrappers' clone and zeros);
//   1. per component: 2*acc half-sweeps (rbgs.cu's packed body, with keep =
//      keep_vel in an obstacle scene), then the deferred red keep multiply;
//   2. the divergence (empty or masked), the 2*acc pressure half-sweeps
//      (keep = fluid_i, scalar faces), the red keep multiply, and the
//      gradient with the velocity faces (and keep_vel).
// 8*acc + 2 grid syncs on an empty scene, 8*acc + 6 on an obstacle scene.
// The per-cell bodies are common.cuh's, the ones rbgs.cu and project.cu
// launch, in the same order, so the result equals the chain bit for bit.
// The inputs are only read (they are the diffusions' prev); every array
// written during the launch is read through plain pointers, never the
// read-only cache, so a read after a grid sync sees the writes before it.
//
// What bounds it on the H100: at 128x64x64 the bytes that must move are the
// three padded fields in and out (13.59 MB, 17.79 MB with the two masks),
// 0.0041 / 0.0053 ms at 3.35 TB/s; the operations ~60 sweeps x 8 per cell,
// 0.0038 ms at 67 TFLOP/s. The chain's fields sit in the 50 MB L2, so what
// the kernel pays beyond the chain's device time is its ~120 grid syncs.
//
// Numerics: every operation rounded on its own (-fmad=false and the
// __fadd_rn/__fmul_rn of the shared bodies).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct PrestepArgs {
  const float* vin[3];   // the inputs: each diffusion's prev, only read
  float* v[3];           // the outputs
  float* rhs;            // the Poisson right-hand side (interior written)
  float* p;              // the pressure
  const float* fl;       // fluid_i (interior view) or null: an empty scene
  const float* kv;       // keep_vel_i (interior view) or null
  int fsz, fsy, ksz, ksy;
  int D, H, W, acc;
  float a, crec;         // the diffusion's a and 1/c
  float prec;            // 1/6, the Poisson solve's 1/c
  float nhh, inv_h, inv_2h;
  int vmask, pmask;      // face signs: velocities (3 fields), pressure
};

// interior cell of flat index t over (D, H, W)
__device__ __forceinline__ void cell_of(long t, int H, int W, int& z, int& y,
                                        int& x) {
  x = static_cast<int>(t % W) + 1;
  const long r = t / W;
  y = static_cast<int>(r % H) + 1;
  z = static_cast<int>(r / H) + 1;
}

// colour cell of flat index t over (D, H, Wc) x-pairs; false past a row end
__device__ __forceinline__ bool colour_of(long t, int color, int H, int W,
                                          int Wc, int& z, int& y, int& x) {
  const int tx = static_cast<int>(t % Wc);
  const long r = t / Wc;
  y = static_cast<int>(r % H) + 1;
  z = static_cast<int>(r / H) + 1;
  x = fst::colour_x(color, z, y, tx);
  return x <= W;
}

// acc packed sweeps of f (keep: interior view or null), then the red keep
// multiply; a grid sync after every phase
__device__ void solve(cg::grid_group& grid, float* f, const float* prev,
                      const float* keep, int ksz, int ksy, float a, float crec,
                      int neg_mask, int field, const PrestepArgs& g, long tid,
                      long nthreads) {
  const int Wc = (g.W + 1) / 2;
  const long ncol = static_cast<long>(g.D) * g.H * Wc;
  int z, y, x;
  for (int s = 0; s < g.acc; ++s) {
    for (int color = 0; color < 2; ++color) {
      for (long t = tid; t < ncol; t += nthreads)
        if (colour_of(t, color, g.H, g.W, Wc, z, y, x))
          fst::rbgs_cell(f, prev, keep, ksz, ksy, g.D, g.H, g.W, a, crec,
                         color, neg_mask, field, z, y, x);
      grid.sync();
    }
  }
  if (keep != nullptr && g.acc > 0) {
    for (long t = tid; t < ncol; t += nthreads)
      if (colour_of(t, 0, g.H, g.W, Wc, z, y, x))
        fst::keep_red_cell(f, keep, ksz, ksy, g.H, g.W, z, y, x);
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads) prestep_kernel(PrestepArgs g) {
  cg::grid_group grid = cg::this_grid();
  const long nthreads = static_cast<long>(gridDim.x) * blockDim.x;
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long npad = static_cast<long>(g.D + 2) * (g.H + 2) * (g.W + 2);
  const long ncell = static_cast<long>(g.D) * g.H * g.W;
  int z, y, x;

  for (long i = tid; i < npad; i += nthreads) {
    g.v[0][i] = g.vin[0][i];
    g.v[1][i] = g.vin[1][i];
    g.v[2][i] = g.vin[2][i];
    g.p[i] = 0.0f;
  }
  grid.sync();

  // the diffusions: component k takes field k's signs of the velocity mask,
  // which are face_signs(k + 1), as K1's own mask for b = k + 1
  for (int k = 0; k < 3; ++k)
    solve(grid, g.v[k], g.vin[k], g.kv, g.ksz, g.ksy, g.a, g.crec, g.vmask,
          k, g, tid, nthreads);

  for (long t = tid; t < ncell; t += nthreads) {
    cell_of(t, g.H, g.W, z, y, x);
    if (g.fl == nullptr)
      fst::divergence_cell(g.v[0], g.v[1], g.v[2], g.rhs, g.D, g.H, g.W,
                           g.nhh, z, y, x);
    else
      fst::divergence_masked_cell(g.v[0], g.v[1], g.v[2], g.fl, g.fsz, g.fsy,
                                  g.rhs, g.D, g.H, g.W, g.nhh, z, y, x);
  }
  grid.sync();

  solve(grid, g.p, g.rhs, g.fl, g.fsz, g.fsy, 1.0f, g.prec, g.pmask, 0, g,
        tid, nthreads);

  for (long t = tid; t < ncell; t += nthreads) {
    cell_of(t, g.H, g.W, z, y, x);
    if (g.fl == nullptr)
      fst::grad_faces_cell(g.v[0], g.v[1], g.v[2], g.p, g.D, g.H, g.W,
                           g.inv_h, g.inv_2h, g.vmask, z, y, x);
    else
      fst::grad_faces_masked_cell(g.v[0], g.v[1], g.v[2], g.p, g.fl, g.fsz,
                                  g.fsy, g.kv, g.ksz, g.ksy, g.D, g.H, g.W,
                                  g.inv_h, g.inv_2h, g.vmask, z, y, x);
  }
}

// blocks of the cooperative grid: every block the card can hold at once
int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prestep_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms * per_sm;
  return 0;
}

}  // namespace

extern "C" {

// Blocks of the prestep's cooperative grid on the current device (threads
// per block: 256); returns a CUDA error code, 0 on success.
int fst_prestep_blocks(int* blocks) { return grid_blocks(blocks); }

// diffuse(1..3) + project of padded (vx, vy, vz) into (ox, oy, oz) in one
// cooperative launch. rhs and p are padded scratch (p is zeroed here); fl
// and kv are interior views with their z/y strides, both null for an empty
// scene. vmask holds the three velocity fields' face signs, pmask the
// pressure's.
int fst_prestep(const void* vx, const void* vy, const void* vz, void* ox,
                void* oy, void* oz, void* rhs, void* p, const void* fl,
                int fsz, int fsy, const void* kv, int ksz, int ksy, int D,
                int H, int W, int acc, float a, float crec, float prec,
                float nhh, float inv_h, float inv_2h, int vmask, int pmask,
                void* stream) {
  int blocks = 0;
  const int err = grid_blocks(&blocks);
  if (err != 0) return err;
  PrestepArgs args{{static_cast<const float*>(vx), static_cast<const float*>(vy),
                    static_cast<const float*>(vz)},
                   {static_cast<float*>(ox), static_cast<float*>(oy),
                    static_cast<float*>(oz)},
                   static_cast<float*>(rhs),
                   static_cast<float*>(p),
                   static_cast<const float*>(fl),
                   static_cast<const float*>(kv),
                   fsz, fsy, ksz, ksy, D, H, W, acc, a, crec, prec, nhh,
                   inv_h, inv_2h, vmask, pmask};
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)prestep_kernel, dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the wrapper raises on the code
    return static_cast<int>(e);
  }
  return fst::launch_status();
}

}  // extern "C"
