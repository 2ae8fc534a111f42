// The streamed, temporally blocked red-black Gauss-Seidel solve of big
// grids: `nsw` sweeps per pass over the data, on the packed (D, H, W)
// pre-keep carry, and the sweep-1 kernel that starts the carry from the
// caller's padded field.
//
// Replaces the JAX package's big-grid solve kernels, which all compute one
// map on the packed pre-keep carry fpre:
//   - rbgs_sweep1: linsolve_stream.py::_make_sweep1_kernel
//     (make_sweep1_packed_call), ROADMAP B10's sweep 1;
//   - rbgs_pass<nsw, keep>: linsolve_mdma.py::_make_sweep_kernel_m (B9,
//     chained by merged_sweep_chain), linsolve_stream.py::_make_sweep_kernel
//     (B10, one sweep per pass) and ::_make_sweep_kernel_t (B11), and the
//     passes of linsolve_temporal.py::_make_pass_kernel (B12, the same map
//     in the padded layout).
//
// The carry (linsolve_stream.py:11-20). After any full sweep every ghost
// face of the solved field equals sign*fpre at the edge cell beside it,
// where fpre is the sweep's pre-keep field (setBounds writes the faces, then
// multiplies by keep, which is 1 on the ghost shell). So a pass carries fpre
// alone: a domain-edge cell reads sign*fpre of ITSELF for its out-of-domain
// neighbour (x+ is an outflow copy, sign +1), and the padded result is
// rebuilt once at the end (kernels/linsolve_stream.py rebuild_padded).
// Sweep 1 is the one sweep that must read the caller's own ghost faces, so
// it runs on the padded field (PADDED), with no keep and no face writes.
//
// Keep inside a pass. The tile holds pre-keep values u. In the red half a
// red cell reads its black neighbours post-keep, u*keep (relax multiplies
// the whole field by keep after each sweep), with keep read through the
// read-only cache rather than a second shared tile, which would halve the
// blocks resident per SM; in the black half a black cell reads its red
// neighbours' fresh pre-keep updates, as relax does. Solid cells are
// updated like any other and their neighbours read those values.
//
// Design: 3-D tiles with shrinking halos in shared memory. A block owns a
// TX x TY x TZ = 32 x 8 x 8 tile of output cells and loads it with a halo of
// M = 2*nsw cells on each of the six sides. Half-sweep h (h = 0 .. 2*nsw-1)
// updates the cells of its colour at tile-local coordinates [h+1, L-2-h]
// on every axis: a cell at h reads neighbours that were valid after h-1,
// so after the last half-sweep exactly the owned tile is right. This is the
// trapezoid of linsolve_mdma.py:233-238 (red extension 2(nsw-s)+1, black
// one cell inside it) in all three directions: a block has 227 KB of shared
// memory, not the tens of MB of VMEM that held whole (H, W) planes on the
// TPU, so x and y are tiled as well as z. Blocks run in no order, so a pass
// reads one buffer and writes another, never in place. Parity comes from
// global packed coordinates: red cells have an odd packed sum (an even
// 1-based one). Offsets into the fields are 64-bit.
//
// Shared memory per block, the u tile:
//   nsw = 1: 36 x 12 x 12 floats = 20,736 B
//   nsw = 2: 40 x 16 x 16 floats = 40,960 B (five blocks per SM)
// Recompute factor (cell updates made / cell updates needed):
//   nsw = 1: (34*10*10 + 32*8*8) / (2*32*8*8) = 1.33
//   nsw = 2: (38*14*14 + 36*12*12 + 34*10*10 + 32*8*8) / (4*32*8*8) = 2.21
// Tile loads per output cell: 2.53 (nsw = 1), 5.00 (nsw = 2); the halo
// re-reads are neighbouring blocks' cells and mostly hit the 50 MB L2.
//
// What bounds it on the H100. Its floor is memory traffic: a pass must read
// fpre and the rhs (and keep) once and write fpre once, two sweeps per pass
// over the data with nsw = 2, against one read of the field and prev per
// half-sweep for the resident kernel (rbgs.cu), whose padded field no longer
// fits the L2 at 256^3 (69 MB) and 512x256x256 (137 MB). The flops (8 per
// cell update, 2.2x recomputed) are far under the f32 rate. As built it
// runs several times over that floor (chip_smoke.py prints the per-call
// times and bounds): each update spends more instructions on its index,
// bounds and splice selects than on its arithmetic, the halo is recomputed,
// and the keep form reads keep six times per red update.
//
// Numerics: the neighbour sum is ((((x+ + x-) + y+) + y-) + z+) + z-, the
// update (rhs + a*s) * (1/c), every operation rounded on its own
// (__fmul_rn/__fadd_rn, -fmad=false): equal to the plain torch passes
// (kernels/linsolve_stream.py) bit for bit.

#include "common.cuh"

namespace {

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
template <int NSW, bool KEEP, bool PADDED>
__global__ void __launch_bounds__(THREADS)
    rbgs_tile_kernel(const float* __restrict__ fin,
                     const float* __restrict__ rhs, int rsz, int rsy,
                     const float* __restrict__ keep, int ksz, int ksy,
                     float* __restrict__ out, int D, int H, int W, float a,
                     float crec, int neg_mask) {
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
      } else {
        // the red half reads black neighbours post-keep
        const long k = static_cast<long>(gz) * ksz +
                       static_cast<long>(gy) * ksy + gx;
        auto nbr = [&](int j, long dk) {
          return (KEEP && !black) ? __fmul_rn(u[j], __ldg(keep + k + dk))
                                  : u[j];
        };
        const float self = u[i];
        xp = gx == W - 1 ? self : nbr(i + 1, 1);
        xm = gx == 0 ? __fmul_rn(sx, self) : nbr(i - 1, -1);
        yp = gy == H - 1 ? __fmul_rn(sy, self) : nbr(i + SY, ksy);
        ym = gy == 0 ? __fmul_rn(sy, self) : nbr(i - SY, -ksy);
        zp = gz == D - 1 ? __fmul_rn(sz, self) : nbr(i + SZ, ksz);
        zm = gz == 0 ? __fmul_rn(sz, self) : nbr(i - SZ, -ksz);
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

template <int NSW, bool KEEP, bool PADDED>
int launch(const void* fin, const void* rhs, int rsz, int rsy,
           const void* keep, int ksz, int ksy, void* out, int D, int H, int W,
           float a, float crec, int neg_mask, void* stream) {
  const dim3 grid(fst::cdiv(W, TX), fst::cdiv(H, TY), fst::cdiv(D, TZ));
  rbgs_tile_kernel<NSW, KEEP, PADDED>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fin), static_cast<const float*>(rhs), rsz,
      rsy, static_cast<const float*>(keep), ksz, ksy,
      static_cast<float*>(out), D, H, W, a, crec, neg_mask);
  return fst::launch_status();
}

}  // namespace

extern "C" {

// Sweep 1: the padded field (its ghost faces as the caller left them) and
// the interior rhs view -> the packed pre-keep field after one sweep.
int fst_rbgs_sweep1(const void* field, const void* rhs, int rsz, int rsy,
                    void* out, int D, int H, int W, float a, float crec,
                    void* stream) {
  return launch<1, false, true>(field, rhs, rsz, rsy, nullptr, 0, 0, out, D,
                                H, W, a, crec, 0, stream);
}

// One pass: the packed pre-keep carry -> the carry nsw (1 or 2) sweeps
// later; keep (an interior view) or nullptr for an empty scene.
int fst_rbgs_pass(const void* fin, const void* rhs, int rsz, int rsy,
                  const void* keep, int ksz, int ksy, void* out, int D, int H,
                  int W, float a, float crec, int nsw, int neg_mask,
                  void* stream) {
  const bool k = keep != nullptr;
  if (nsw == 1)
    return k ? launch<1, true, false>(fin, rhs, rsz, rsy, keep, ksz, ksy, out,
                                      D, H, W, a, crec, neg_mask, stream)
             : launch<1, false, false>(fin, rhs, rsz, rsy, keep, ksz, ksy,
                                       out, D, H, W, a, crec, neg_mask,
                                       stream);
  if (nsw == 2)
    return k ? launch<2, true, false>(fin, rhs, rsz, rsy, keep, ksz, ksy, out,
                                      D, H, W, a, crec, neg_mask, stream)
             : launch<2, false, false>(fin, rhs, rsz, rsy, keep, ksz, ksy,
                                       out, D, H, W, a, crec, neg_mask,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
