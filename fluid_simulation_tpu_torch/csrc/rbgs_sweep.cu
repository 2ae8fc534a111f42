// One red-black sweep on a sharded z-slab, in its packed and padded layouts.
//
// Replaces fluid_simulation_tpu/kernels/linsolve_sweep.py:
//   - pallas_rbgs_sweep_packed (_make_packed_sweep_kernel, ROADMAP B15): the
//     sweep of the sharded solve (parallel/sharded.py), on the slab's packed
//     (Dl, H, W) interior with explicit x/y ghost planes and z halo planes;
//   - pallas_rbgs_sweep (_make_sweep_kernel, ROADMAP B20): the same sweep on
//     the padded (Dl+2, H+2, W+2) slab, which no route takes.
// On the TPU one pallas_call held the whole slab in VMEM and ran both halves
// in it. Here blocks run in no order, so the launch boundary is the barrier
// between the red and the black half, as in rbgs.cu: one thread per cell.
//
// Packed (two launches). The red launch writes every cell of a scratch f1:
// the red update, or the input value of a black cell; its z neighbours at
// local rows -1 and Dl come from the halo planes znlo/znhi. The black launch
// reads f1, takes the black-phase planes bp_lo/bp_hi as z neighbours, and
// writes every cell of the output as f2*keep, red cells included: one call
// is one whole sweep, so the red cells get their keep here and not in a
// deferred launch as in rbgs.cu. Its edge threads write the next sweep's
// ghost planes, sign times the pre-keep f2 (x+ a plain copy): gx0/gx1
// (Dl, H), gy0/gy1 (Dl, W), gz0/gz1 (H, W). Both halves read the same x/y
// ghost planes. rhs and keep are interior views with their own z/y strides.
//
// Padded (three launches, in place on the wrapper's clone). Red, then black
// half-sweep, one thread per cell of the colour; the black half takes its z
// neighbours at rows 0 and Dl+1 from bp_lo/bp_hi instead of the slab (the
// TPU kernel copied the planes into those rows first). Each edge thread
// writes its own mirrors right after its update, as rbgs.cu does: x and y
// faces on the interior rows, and sz*u into rows 0 and Dl+1. No other cell
// reads those ghosts inside the launch. A closing launch zeroes the borders
// of rows 0 and Dl+1 and, with a keep, multiplies the whole padded slab by
// it, ghosts included.
//
// The z-blocked solve (ROADMAP B22c). Replaces
// tools/linsolve_blocked.py::pallas_rbgs_solve_blocked (_make_sweep_kernel),
// one pallas_call per full padded sweep that streamed z-blocks through VMEM
// with a two-row halo: red, black, x/y faces on the interior rows, the z
// faces' interiors, then the whole padded field times keep. The card needs
// no z-blocks: the padded kernels above hold one whole sweep once the black
// half reads its z neighbours from the field's own rows 0 and Dl+1 (null
// bplo/bphi; the red half's mirrors there sit on red columns, which no black
// cell reads), and the closing launch keeps the borders of those rows
// (zero_borders = 0), which B20 zeroes and the blocked sweep passes through.
// Without keep the closing launch has nothing to do and is skipped.
//
// What bounds it on the H100: bytes and launches. A packed sweep reads the
// field twice, rhs twice and keep once, and writes f1 and the output: at the
// 256^3 slab over two ranks (128x256x256) that is ~235 MB of traffic
// against ~168 MB that must move, and the wrapper's torch glue (black-phase
// planes, padded halo planes) around each call is launch-bound.
//
// Numerics: ((((x+ + x-) + y+) + y-) + z+) + z-, then (rhs + a*s) * (1/c),
// each operation rounded on its own (__fadd_rn/__fmul_rn, -fmad=false), so
// both kernels equal their plain torch versions bit for bit.

#include "common.cuh"

namespace {

__device__ __forceinline__ float update(float xp, float xm, float yp,
                                        float ym, float zp, float zm,
                                        float rhs, float a, float crec) {
  float s = __fadd_rn(xp, xm);
  s = __fadd_rn(s, yp);
  s = __fadd_rn(s, ym);
  s = __fadd_rn(s, zp);
  s = __fadd_rn(s, zm);
  return __fmul_rn(__fadd_rn(rhs, __fmul_rn(a, s)), crec);
}

// red = local 0-based z+y+x odd (the 1-based coordinate sum even)
__device__ __forceinline__ bool is_red(int z, int y, int x) {
  return ((z + y + x) & 1) == 1;
}

struct Ghosts {
  const float *gx0, *gx1, *gy0, *gy1, *zlo, *zhi;
};

// The update of packed cell (z, y, x), 0-based, from f (Dl, H, W): interior
// neighbours from f, the others from the ghost planes.
__device__ __forceinline__ float packed_update(
    const float* __restrict__ f, const float* __restrict__ rp, int rsz,
    int rsy, const Ghosts& g, int z, int y, int x, int Dl, int H, int W,
    float a, float crec) {
  const long hw = static_cast<long>(H) * W;
  const long i = z * hw + static_cast<long>(y) * W + x;
  const float xp = x == W - 1 ? g.gx1[z * H + y] : f[i + 1];
  const float xm = x == 0 ? g.gx0[z * H + y] : f[i - 1];
  const float yp = y == H - 1 ? g.gy1[z * W + x] : f[i + W];
  const float ym = y == 0 ? g.gy0[z * W + x] : f[i - W];
  const float zp = z == Dl - 1 ? g.zhi[y * W + x] : f[i + hw];
  const float zm = z == 0 ? g.zlo[y * W + x] : f[i - hw];
  const float rhs = rp[static_cast<long>(z) * rsz + static_cast<long>(y) * rsy +
                       x];
  return update(xp, xm, yp, ym, zp, zm, rhs, a, crec);
}

__global__ void packed_red_kernel(const float* __restrict__ fk,
                                  const float* __restrict__ rp, int rsz,
                                  int rsy, Ghosts g, float* __restrict__ f1,
                                  int Dl, int H, int W, float a, float crec) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= W || y >= H) return;
  const long i = (static_cast<long>(z) * H + y) * W + x;
  f1[i] = is_red(z, y, x)
              ? packed_update(fk, rp, rsz, rsy, g, z, y, x, Dl, H, W, a, crec)
              : fk[i];
}

struct Outs {
  float *f, *gx0, *gx1, *gy0, *gy1, *gz0, *gz1;
};

__global__ void packed_black_kernel(const float* __restrict__ f1,
                                    const float* __restrict__ rp, int rsz,
                                    int rsy, const float* __restrict__ kp,
                                    int ksz, int ksy, Ghosts g, Outs o,
                                    int Dl, int H, int W, float a, float crec,
                                    int neg_mask) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= W || y >= H) return;
  const long i = (static_cast<long>(z) * H + y) * W + x;
  const float f2 =
      is_red(z, y, x)
          ? f1[i]
          : packed_update(f1, rp, rsz, rsy, g, z, y, x, Dl, H, W, a, crec);
  const float k = kp[static_cast<long>(z) * ksz + static_cast<long>(y) * ksy +
                     x];
  o.f[i] = __fmul_rn(f2, k);
  if (x == 0) o.gx0[z * H + y] = __fmul_rn(fst::face_sign(neg_mask, 0, 0), f2);
  if (x == W - 1) o.gx1[z * H + y] = f2;
  if (y == 0) o.gy0[z * W + x] = __fmul_rn(fst::face_sign(neg_mask, 0, 1), f2);
  if (y == H - 1)
    o.gy1[z * W + x] = __fmul_rn(fst::face_sign(neg_mask, 0, 1), f2);
  if (z == 0) o.gz0[y * W + x] = __fmul_rn(fst::face_sign(neg_mask, 0, 2), f2);
  if (z == Dl - 1)
    o.gz1[y * W + x] = __fmul_rn(fst::face_sign(neg_mask, 0, 2), f2);
}

// One half-sweep of the padded slab in place: the cells of colour `color`
// (0 red, 1 black); the black half reads its z neighbours at rows 0 and
// Dl+1 from the planes bplo/bphi, shaped (H+2, W+2).
__global__ void padded_half_kernel(float* f, const float* __restrict__ prev,
                                   const float* __restrict__ bplo,
                                   const float* __restrict__ bphi, int Dl,
                                   int H, int W, float a, float crec,
                                   int color, int neg_mask) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (y > H) return;
  // padded z+y+x even is red
  const int x = 1 + 2 * t + ((z + y + 1 + color) & 1);
  if (x > W) return;
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const long p = y * sy + x;   // index in a padded plane
  const float zp =
      (color == 1 && z == Dl && bphi != nullptr) ? bphi[p] : f[i + sz];
  const float zm =
      (color == 1 && z == 1 && bplo != nullptr) ? bplo[p] : f[i - sz];
  const float u = update(f[i + 1], f[i - 1], f[i + sy], f[i - sy], zp, zm,
                         prev[i], a, crec);
  f[i] = u;
  fst::write_faces(f, i, sy, sz, z, y, x, Dl, H, W, u, neg_mask, 0);
}

// With zero_borders, the borders of rows 0 and Dl+1 zeroed; with keep, the
// whole slab times keep.
__global__ void padded_finish_kernel(float* f, const float* __restrict__ keep,
                                     int Dl, int H, int W, int zero_borders) {
  const long n = static_cast<long>(Dl + 2) * (H + 2) * (W + 2);
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % (W + 2));
  const int y = static_cast<int>((i / (W + 2)) % (H + 2));
  const int z = static_cast<int>(i / (static_cast<long>(W + 2) * (H + 2)));
  const bool border = zero_borders && (z == 0 || z == Dl + 1) &&
                      (x == 0 || x == W + 1 || y == 0 || y == H + 1);
  if (keep == nullptr) {
    if (border) f[i] = 0.0f;
    return;
  }
  f[i] = __fmul_rn(border ? 0.0f : f[i], keep[i]);
}

const dim3 kBlock(32, 8, 1);

}  // namespace

extern "C" {

// The red half of a packed sweep: f1 = red ? update(fk) : fk.
int fst_sweep_packed_red(const void* fk, const void* rp, int rsz, int rsy,
                         const void* gx0, const void* gx1, const void* gy0,
                         const void* gy1, const void* znlo, const void* znhi,
                         void* f1, int Dl, int H, int W, float a, float crec,
                         void* stream) {
  const Ghosts g{static_cast<const float*>(gx0), static_cast<const float*>(gx1),
                 static_cast<const float*>(gy0), static_cast<const float*>(gy1),
                 static_cast<const float*>(znlo),
                 static_cast<const float*>(znhi)};
  const dim3 grid(fst::cdiv(W, kBlock.x), fst::cdiv(H, kBlock.y), Dl);
  packed_red_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fk), static_cast<const float*>(rp), rsz, rsy,
      g, static_cast<float*>(f1), Dl, H, W, a, crec);
  return fst::launch_status();
}

// The black half of a packed sweep: out = f2 * keep, and the ghost planes
// of the next sweep.
int fst_sweep_packed_black(const void* f1, const void* rp, int rsz, int rsy,
                           const void* kp, int ksz, int ksy, const void* gx0,
                           const void* gx1, const void* gy0, const void* gy1,
                           const void* bplo, const void* bphi, void* out,
                           void* ogx0, void* ogx1, void* ogy0, void* ogy1,
                           void* ogz0, void* ogz1, int Dl, int H, int W,
                           float a, float crec, int neg_mask, void* stream) {
  const Ghosts g{static_cast<const float*>(gx0), static_cast<const float*>(gx1),
                 static_cast<const float*>(gy0), static_cast<const float*>(gy1),
                 static_cast<const float*>(bplo),
                 static_cast<const float*>(bphi)};
  const Outs o{static_cast<float*>(out),  static_cast<float*>(ogx0),
               static_cast<float*>(ogx1), static_cast<float*>(ogy0),
               static_cast<float*>(ogy1), static_cast<float*>(ogz0),
               static_cast<float*>(ogz1)};
  const dim3 grid(fst::cdiv(W, kBlock.x), fst::cdiv(H, kBlock.y), Dl);
  packed_black_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(rp), rsz, rsy,
      static_cast<const float*>(kp), ksz, ksy, g, o, Dl, H, W, a, crec,
      neg_mask);
  return fst::launch_status();
}

// One half-sweep (color 0 red, 1 black) of the padded slab f in place;
// null bplo/bphi read the slab's own rows 0 and Dl+1.
int fst_sweep_half(void* f, const void* prev, const void* bplo,
                   const void* bphi, int Dl, int H, int W, float a, float crec,
                   int color, int neg_mask, void* stream) {
  const dim3 grid(fst::cdiv((W + 1) / 2, kBlock.x), fst::cdiv(H, kBlock.y),
                  Dl);
  padded_half_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(prev),
      static_cast<const float*>(bplo), static_cast<const float*>(bphi), Dl, H,
      W, a, crec, color, neg_mask);
  return fst::launch_status();
}

// The padded sweep's closing launch; keep is null or the padded keep.
int fst_sweep_finish(void* f, const void* keep, int Dl, int H, int W,
                     int zero_borders, void* stream) {
  const long n = static_cast<long>(Dl + 2) * (H + 2) * (W + 2);
  const int block = 256;
  padded_finish_kernel<<<fst::cdiv(n, block), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(keep), Dl, H, W,
      zero_borders);
  return fst::launch_status();
}

}  // extern "C"
