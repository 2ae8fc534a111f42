// The step's two statistics in one pass over the fields: the density sum
// over the whole padded dens and the largest |divergence| of the padded
// velocities, written to out = [density_sum, max_divergence].
//
// Replaces no TPU kernel: in the JAX package (models/windtunnel.py) XLA
// fused these reductions into its own glue. The port computed them with
// plain torch ops, a chain of whole-field passes that read some 13 fields
// and wrote some 10 a step; this kernel reads each field once.
//
// Design: a grid sized to the card (the wrapper gives sm_count x
// kBlocksPerSm blocks of kThreads), one padded row (z, y) a warp at a time,
// warps striding over the rows, lanes over x. A thread adds every dens
// cell of its rows, in order, and takes the divergence of each interior
// cell among them (common.cuh's divergence_at, the projections' own
// arithmetic); an interior row's cells run without a branch, so that a
// thread has the loads of four cells in flight. Each block reduces its
// threads' sums and maxima by a fixed warp and block tree into one
// partial; a second launch of one block adds the partials in block order.
// No atomics, so the sum is the same bits on every run on a given card.
//
// What bounds it on the H100: memory traffic. It reads four padded fields
// and, in an obstacle scene, the interior fluid_i once each (681.6 MB at
// 512x256x256, 0.2035 ms at 3.35 TB/s); the neighbour reads of the
// divergence hit L1 (rows y +- 1 belong to the same block) or L2 (planes
// z +- 1 are read by blocks running at the same time). Bytes in flight set
// the pace: four cells a thread (79 registers) at three blocks an SM ran
// the masked pass at 512x256x256 in 0.236 ms and the empty one in 0.181,
// against 0.284 and 0.188 at two cells and four blocks, 0.612 and 0.216 at
// eight blocks (32 registers, spilling); torch.sum reads 681.6 MB in 0.228
// (PERF.md).
//
// Numerics: the divergence is bitwise the plain one (ops/project.py); the
// maximum runs over the bits of |div| as unsigned integers from 0, which
// orders non-negative floats as floats do and puts every NaN above inf, so
// a NaN anywhere gives NaN as torch.max does. The sum is float32 in the
// order above: it differs from torch.sum by rounding only.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM holds at once under the register cap below; the wrapper
// sizes the grid with the same number (kernels/stats.py BLOCKS_PER_SM)
constexpr int kBlocksPerSm = 3;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kNanBits = 0x7fc00000u;  // float("nan")

// Sum and maximum of a block's threads, into thread 0, by a fixed tree.
__device__ __forceinline__ void block_reduce(float& s, unsigned& mx) {
  __shared__ float ssum[kWarps];
  __shared__ unsigned smax[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    const unsigned b = __shfl_down_sync(0xffffffffu, mx, o);
    mx = b > mx ? b : mx;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ssum[warp] = s;
    smax[warp] = mx;
  }
  __syncthreads();
  if (warp != 0) return;
  s = lane < kWarps ? ssum[lane] : 0.0f;
  mx = lane < kWarps ? smax[lane] : 0u;
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    const unsigned b = __shfl_down_sync(0xffffffffu, mx, o);
    mx = b > mx ? b : mx;
  }
}

// part: gridDim.x sums, then gridDim.x maxima as float bits
template <bool DIV, bool MASKED, bool SUM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stats_partial_kernel(const float* __restrict__ vx,
                         const float* __restrict__ vy,
                         const float* __restrict__ vz,
                         const float* __restrict__ dens,
                         const float* __restrict__ fl, int fsz, int fsy,
                         float* __restrict__ part, int D, int H, int W,
                         float neg_half_h) {
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const int rows = (D + 2) * (H + 2);
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  unsigned mx = 0u;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * kWarps) {
    const int z = r / (H + 2), y = r - z * (H + 2);
    const long row = static_cast<long>(r) * sy;
    if (!(DIV && z >= 1 && z <= D && y >= 1 && y <= H)) {
      if (SUM)
        for (int x = lane; x < W + 2; x += 32)
          s = __fadd_rn(s, dens[row + x]);
      continue;
    }
    // an interior row: its cells without a branch, so that the loads of
    // four cells are in flight at once; lane 0 adds the two ghost ends
    if (SUM && lane == 0) s = __fadd_rn(s, dens[row]);
#pragma unroll 4
    for (int x = 1 + lane; x <= W; x += 32) {
      const long i = row + x;
      if (SUM) s = __fadd_rn(s, dens[i]);
      const long m = MASKED ? fst::mask_index(z, y, x, fsz, fsy) : 0;
      const float d = fst::divergence_at<MASKED>(vx, vy, vz, fl, m, fsz, fsy,
                                                 i, sy, sz, D, H, W,
                                                 neg_half_h, z, y, x);
      const unsigned b = __float_as_uint(fabsf(d));
      mx = b > mx ? b : mx;
    }
    if (SUM && lane == 0) s = __fadd_rn(s, dens[row + W + 1]);
  }
  block_reduce(s, mx);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    reinterpret_cast<unsigned*>(part)[gridDim.x + blockIdx.x] = mx;
  }
}

// One block: the partials in block order, then the two statistics (NaN for
// one that is off).
__global__ void __launch_bounds__(kThreads)
    stats_finish_kernel(const float* __restrict__ part, int blocks,
                        float* __restrict__ out, int div, int sum) {
  float s = 0.0f;
  unsigned mx = 0u;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    s = __fadd_rn(s, part[b]);
    const unsigned m = reinterpret_cast<const unsigned*>(part)[blocks + b];
    mx = m > mx ? m : mx;
  }
  block_reduce(s, mx);
  if (threadIdx.x == 0) {
    out[0] = sum ? s : __uint_as_float(kNanBits);
    out[1] = div ? __uint_as_float(mx) : __uint_as_float(kNanBits);
  }
}

template <bool DIV, bool MASKED, bool SUM>
void launch_partial(const void* vx, const void* vy, const void* vz,
                    const void* dens, const void* fl, int fsz, int fsy,
                    void* part, int blocks, int D, int H, int W,
                    float neg_half_h, cudaStream_t stream) {
  stats_partial_kernel<DIV, MASKED, SUM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(dens),
      static_cast<const float*>(fl), fsz, fsy, static_cast<float*>(part), D,
      H, W, neg_half_h);
}

}  // namespace

extern "C" {

// out[0] = the float32 sum of the padded dens (with sum), out[1] = max
// |-0.5h * divergence| of the padded (vx, vy, vz) over the interior (with
// div), NaN for a statistic that is off; at least one is on. With fl (an
// interior fluid_i view, strides fsz/fsy) the obstacle form of the
// divergence, else the empty form. part holds 2 * blocks floats.
int fst_step_stats(const void* vx, const void* vy, const void* vz,
                   const void* dens, const void* fl, int fsz, int fsy,
                   void* part, void* out, int blocks, int D, int H, int W,
                   float neg_half_h, int div, int sum, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (!div && !sum) return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = fl != nullptr;
  if (!div)
    launch_partial<false, false, true>(vx, vy, vz, dens, fl, fsz, fsy, part,
                                       blocks, D, H, W, neg_half_h, st);
  else if (masked && sum)
    launch_partial<true, true, true>(vx, vy, vz, dens, fl, fsz, fsy, part,
                                     blocks, D, H, W, neg_half_h, st);
  else if (masked)
    launch_partial<true, true, false>(vx, vy, vz, dens, fl, fsz, fsy, part,
                                      blocks, D, H, W, neg_half_h, st);
  else if (sum)
    launch_partial<true, false, true>(vx, vy, vz, dens, fl, fsz, fsy, part,
                                      blocks, D, H, W, neg_half_h, st);
  else
    launch_partial<true, false, false>(vx, vy, vz, dens, fl, fsz, fsy, part,
                                       blocks, D, H, W, neg_half_h, st);
  const int rc = fst::launch_status();
  if (rc != 0) return rc;
  stats_finish_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(part), blocks, static_cast<float*>(out), div,
      sum);
  return fst::launch_status();
}

}  // extern "C"
