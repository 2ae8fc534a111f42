// The tile kernel of the streamed red-black pass (rbgs_stream.cu's design
// note says what it computes and why it is shaped so), shared by the
// production kernels of rbgs_stream.cu and the sweep-cost variants of
// sweepcost.cu. The Variant parameter removes one mechanism of the pass at a
// time; rbgs_stream.cu instantiates only kFull, so the production kernel is
// this code with every variant branch compiled out.
//
// The variants (sweepcost.cu says how they map onto the JAX probe's,
// tools/exp_sweepcost.py:11-16). Each is deterministic: every cell of a
// half-sweep's colour reads only cells of the other colour or itself, so
// no thread reads a cell that another writes in the same half-sweep.
//   kFull   the production pass;
//   kNoSel  no domain-edge splice: a neighbour outside the domain is read
//           from the tile, which holds zeros there (zero ghost faces);
//   kNoIota no per-update domain test: cells of the tile outside the domain
//           are updated too (rhs read at the clamped coordinate), never
//           read by a cell inside it (the splices) and never stored, so the
//           result is kFull's;
//   kNoRoll no x/y neighbour reads: x+, x-, y+ and y- are the cell itself;
//   kNoZn   no z neighbour reads: z+ and z- are the cell itself;
//   kArith  no neighbour reads and no colours: every cell of the region,
//           both colours, u = (rhs + a*(6*u)) * (1/c) in each half-sweep,
//           with the tile load and the store as they are.
#pragma once

#include "common.cuh"

namespace {

enum Variant { kFull = 0, kNoSel, kNoIota, kNoRoll, kNoZn, kArith };

constexpr int TX = 32, TY = 8, TZ = 8;
constexpr int THREADS = 256;

template <int NSW>
struct Tile {
  static constexpr int M = 2 * NSW;
  static constexpr int LX = TX + 2 * M, LY = TY + 2 * M, LZ = TZ + 2 * M;
  static constexpr int N = LX * LY * LZ;
};

// PADDED: fin is the padded (D+2, H+2, W+2) field (sweep 1: its ghost cells
// are loaded and read, never spliced). Otherwise fin is the packed pre-keep
// carry. rhs and keep are interior (D, H, W) views with z/y strides and x
// stride 1; out is packed.
template <int NSW, bool KEEP, bool PADDED, int V = kFull>
__global__ void __launch_bounds__(THREADS)
    rbgs_tile_kernel(const float* __restrict__ fin,
                     const float* __restrict__ rhs, int rsz, int rsy,
                     const float* __restrict__ keep, int ksz, int ksy,
                     float* __restrict__ out, int D, int H, int W, float a,
                     float crec, int neg_mask) {
  static_assert(V == kFull || (!KEEP && !PADDED),
                "the variants exist for the empty-scene pass only");
  using T = Tile<NSW>;
  __shared__ float u[T::N];
  const int x0 = blockIdx.x * TX - T::M;
  const int y0 = blockIdx.y * TY - T::M;
  const int z0 = blockIdx.z * TZ - T::M;

  for (int i = threadIdx.x; i < T::N; i += THREADS) {
    const int gx = x0 + i % T::LX;
    const int gy = y0 + (i / T::LX) % T::LY;
    const int gz = z0 + i / (T::LX * T::LY);
    const bool inside = gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 &&
                        gz < D;
    float v = 0.0f;
    if (PADDED) {
      if (gx >= -1 && gx <= W && gy >= -1 && gy <= H && gz >= -1 && gz <= D)
        v = fin[(static_cast<long>(gz + 1) * (H + 2) + (gy + 1)) * (W + 2) +
                (gx + 1)];
    } else if (inside) {
      v = fin[(static_cast<long>(gz) * H + gy) * W + gx];
    }
    u[i] = v;
  }
  __syncthreads();

  const float sx = fst::face_sign(neg_mask, 0, 0);
  const float sy = fst::face_sign(neg_mask, 0, 1);
  const float sz = fst::face_sign(neg_mask, 0, 2);
  constexpr int SY = T::LX, SZ = T::LX * T::LY;
  // unrolled, so that each half-sweep's region is a compile-time constant
  // and its index divisions become multiplies
#pragma unroll
  for (int h = 0; h < 2 * NSW; ++h) {
    const int black = h & 1;
    const int lo = h + 1;
    const int nx = T::LX - 2 * lo, ny = T::LY - 2 * lo, nz = T::LZ - 2 * lo;
    if constexpr (V == kArith) {
      for (int t = threadIdx.x; t < nx * ny * nz; t += THREADS) {
        const int r = t / nx;
        const int lx = lo + t % nx, ly = lo + r % ny, lz = lo + r / ny;
        const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
        if (gx < 0 || gx >= W || gy < 0 || gy >= H || gz < 0 || gz >= D)
          continue;
        const int i = lz * SZ + ly * SY + lx;
        const float b = rhs[static_cast<long>(gz) * rsz +
                            static_cast<long>(gy) * rsy + gx];
        u[i] = __fmul_rn(__fadd_rn(b, __fmul_rn(a, __fmul_rn(6.0f, u[i]))),
                         crec);
      }
      __syncthreads();
      continue;
    }
    const int nxh = (nx + 1) / 2;   // cells of one colour per row, at most
    for (int t = threadIdx.x; t < nxh * ny * nz; t += THREADS) {
      const int r = t / nxh;
      const int ly = lo + r % ny, lz = lo + r / ny;
      int lx = lo + 2 * (t % nxh);
      const int gy = y0 + ly, gz = z0 + lz;
      int gx = x0 + lx;
      // red (black == 0): odd packed coordinate sum
      if (((gx + gy + gz) & 1) == black) {
        ++lx;
        ++gx;
      }
      if constexpr (V == kNoIota) {
        // the update below without its domain test, in a copy of its own:
        // any change to the production test changes its machine code
        if (lx >= lo + nx) continue;
        const int i = lz * SZ + ly * SY + lx;
        const float self = u[i];
        float s = __fadd_rn(gx == W - 1 ? self : u[i + 1],
                            gx == 0 ? __fmul_rn(sx, self) : u[i - 1]);
        s = __fadd_rn(s, gy == H - 1 ? __fmul_rn(sy, self) : u[i + SY]);
        s = __fadd_rn(s, gy == 0 ? __fmul_rn(sy, self) : u[i - SY]);
        s = __fadd_rn(s, gz == D - 1 ? __fmul_rn(sz, self) : u[i + SZ]);
        s = __fadd_rn(s, gz == 0 ? __fmul_rn(sz, self) : u[i - SZ]);
        const float b =
            rhs[static_cast<long>(min(max(gz, 0), D - 1)) * rsz +
                static_cast<long>(min(max(gy, 0), H - 1)) * rsy +
                min(max(gx, 0), W - 1)];
        u[i] = __fmul_rn(__fadd_rn(b, __fmul_rn(a, s)), crec);
        continue;
      }
      if (lx >= lo + nx || gx < 0 || gx >= W || gy < 0 || gy >= H ||
          gz < 0 || gz >= D)
        continue;
      const int i = lz * SZ + ly * SY + lx;
      float xp, xm, yp, ym, zp, zm;
      if (PADDED) {
        xp = u[i + 1];
        xm = u[i - 1];
        yp = u[i + SY];
        ym = u[i - SY];
        zp = u[i + SZ];
        zm = u[i - SZ];
      } else if constexpr (V == kNoSel) {
        xp = u[i + 1];
        xm = u[i - 1];
        yp = u[i + SY];
        ym = u[i - SY];
        zp = u[i + SZ];
        zm = u[i - SZ];
      } else {
        // the red half reads black neighbours post-keep
        const long k = static_cast<long>(gz) * ksz +
                       static_cast<long>(gy) * ksy + gx;
        auto nbr = [&](int j, long dk) {
          return (KEEP && !black) ? __fmul_rn(u[j], __ldg(keep + k + dk))
                                  : u[j];
        };
        const float self = u[i];
        if constexpr (V == kNoRoll) {
          xp = xm = yp = ym = self;
        } else {
          xp = gx == W - 1 ? self : nbr(i + 1, 1);
          xm = gx == 0 ? __fmul_rn(sx, self) : nbr(i - 1, -1);
          yp = gy == H - 1 ? __fmul_rn(sy, self) : nbr(i + SY, ksy);
          ym = gy == 0 ? __fmul_rn(sy, self) : nbr(i - SY, -ksy);
        }
        if constexpr (V == kNoZn) {
          zp = zm = self;
        } else {
          zp = gz == D - 1 ? __fmul_rn(sz, self) : nbr(i + SZ, ksz);
          zm = gz == 0 ? __fmul_rn(sz, self) : nbr(i - SZ, -ksz);
        }
      }
      float s = __fadd_rn(xp, xm);
      s = __fadd_rn(s, yp);
      s = __fadd_rn(s, ym);
      s = __fadd_rn(s, zp);
      s = __fadd_rn(s, zm);
      const float b = rhs[static_cast<long>(gz) * rsz +
                          static_cast<long>(gy) * rsy + gx];
      u[i] = __fmul_rn(__fadd_rn(b, __fmul_rn(a, s)), crec);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TX * TY * TZ; i += THREADS) {
    const int ox = i % TX, oy = (i / TX) % TY, oz = i / (TX * TY);
    const int gx = blockIdx.x * TX + ox;
    const int gy = blockIdx.y * TY + oy;
    const int gz = blockIdx.z * TZ + oz;
    if (gx < W && gy < H && gz < D)
      out[(static_cast<long>(gz) * H + gy) * W + gx] =
          u[(oz + T::M) * SZ + (oy + T::M) * SY + ox + T::M];
  }
}

template <int NSW, bool KEEP, bool PADDED, int V = kFull>
int launch_tile(const void* fin, const void* rhs, int rsz, int rsy,
                const void* keep, int ksz, int ksy, void* out, int D, int H,
                int W, float a, float crec, int neg_mask, void* stream) {
  const dim3 grid(fst::cdiv(W, TX), fst::cdiv(H, TY), fst::cdiv(D, TZ));
  rbgs_tile_kernel<NSW, KEEP, PADDED, V>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fin), static_cast<const float*>(rhs), rsz,
      rsy, static_cast<const float*>(keep), ksz, ksy,
      static_cast<float*>(out), D, H, W, a, crec, neg_mask);
  return fst::launch_status();
}

}  // namespace
