// Colour-packed red-black Gauss-Seidel half-sweeps: one kernel per colour,
// each updating a whole (D, H, W/2) colour half in place.
//
// Replaces tools/linsolve_cpack.py::pallas_rbgs_solve_cpack (the resident
// kernel, _make_cpack_kernel) and ::pallas_rbgs_solve_cpack_stream (the
// z-blocked per-sweep kernel, _make_cpack_sweep_kernel), ROADMAP B22b. Both
// TPU entry points run sweep 1 in a padded solve and sweeps 2..acc on the
// colour halves (0-based interior coordinates, pr = (1 + z + y) % 2):
//   R[z, y, i] = f[z, y, 2i + pr],  B[z, y, i] = f[z, y, 2i + 1 - pr].
// Every y and z neighbour of a red cell is the lane-aligned black cell of
// the row above or below, and its x neighbours are the aligned lane and
// the lane to the left (pr = 0) or right (pr = 1); black mirrors that.
//
// Design. The TPU kernels kept the halves resident in VMEM (or streamed
// z-blocks with a red halo recompute); on the card a launch boundary is the
// grid-wide barrier, so one pair of launches is one sweep and the same pair
// serves both entry points:
//   cpack_red_kernel:   R[i] = (PR[i] + a*s(B)) * (1/c)
//   cpack_black_kernel: B[i] = (PB[i] + a*s(R)) * (1/c)
// one thread per cell of the half, in place. Each thread reads only the
// other colour plus its own cell, before writing its own cell, so in-place
// is race-free. The halves carry the PRE-KEEP values (as the streamed TPU
// kernel does): red reads black as B*KB (the post-keep black, formed as it
// is read), black reads red unmasked (red is pre-keep within a sweep, as in
// K1), and the keep is applied once after the last sweep by the wrapper.
// A ghost neighbour is sign * the cell's own pre-keep value from the last
// sweep, which is what the padded solve's ghost face holds then: the x+
// face is a plain copy, the others take the field's mirror signs.
//
// What bounds it on the H100: bytes. A half-sweep reads the other half
// (each value by up to six neighbours, mostly from L1/L2), its own half,
// its rhs half and, for red with a keep, the keep half, and writes its own
// half: per sweep 4 (keep: 5) half-field reads and 2 half-field writes of
// contiguous rows, where K1's half-sweep reads and writes a stride-2
// checkerboard of the whole padded field and wastes half of every sector.
//
// Numerics: the neighbour sum is left-associated ((((x+ + x-) + y+) + y-)
// + z+) + z-, as in K1, and every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, -fmad=false), so the result equals the plain torch
// half-sweep (kernels/linsolve_cpack.py) and the port's K1 bit for bit.

#include "common.cuh"

namespace {

const dim3 kBlock(32, 8, 1);

// the other colour's value at j, times its keep where one is given
__device__ __forceinline__ float other_at(const float* __restrict__ other,
                                          const float* __restrict__ kother,
                                          long j) {
  return kother != nullptr ? __fmul_rn(other[j], kother[j]) : other[j];
}

// One cell (z, y, i) of a half-sweep of colour RED (true) or black. `own`
// is the half updated in place, `other` the opposite colour (with its
// keep `kother`, or null), `prev` the rhs half.
template <bool RED>
__device__ __forceinline__ void cpack_cell(float* __restrict__ own,
                                           const float* __restrict__ other,
                                           const float* __restrict__ kother,
                                           const float* __restrict__ prev,
                                           int D, int H, int Wh, float a,
                                           float crec, int neg_mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (i >= Wh || y >= H) return;
  const long sy = Wh;
  const long sz = static_cast<long>(H) * Wh;
  const long j = z * sz + y * sy + i;
  const float pre = own[j];     // this cell's pre-keep value, last sweep
  // pr == 0 <=> z + y odd. The opposite colour's second x neighbour sits
  // one lane to the left when `left` (red on pr == 0 rows, black on
  // pr == 1 rows), else one lane to the right.
  const bool pr0 = ((z + y) & 1) == 1;
  const bool left = RED ? pr0 : !pr0;
  float xp, xm;
  if (left) {
    xp = other_at(other, kother, j);
    xm = i == 0 ? __fmul_rn(fst::face_sign(neg_mask, 0, 0), pre)
                : other_at(other, kother, j - 1);
  } else {
    xp = i == Wh - 1 ? pre : other_at(other, kother, j + 1);   // x+ copy
    xm = other_at(other, kother, j);
  }
  const float sgy = fst::face_sign(neg_mask, 0, 1);
  const float sgz = fst::face_sign(neg_mask, 0, 2);
  const float yp = y == H - 1 ? __fmul_rn(sgy, pre)
                              : other_at(other, kother, j + sy);
  const float ym = y == 0 ? __fmul_rn(sgy, pre)
                          : other_at(other, kother, j - sy);
  const float zp = z == D - 1 ? __fmul_rn(sgz, pre)
                              : other_at(other, kother, j + sz);
  const float zm = z == 0 ? __fmul_rn(sgz, pre)
                          : other_at(other, kother, j - sz);
  float s = __fadd_rn(xp, xm);
  s = __fadd_rn(s, yp);
  s = __fadd_rn(s, ym);
  s = __fadd_rn(s, zp);
  s = __fadd_rn(s, zm);
  own[j] = __fmul_rn(__fadd_rn(prev[j], __fmul_rn(a, s)), crec);
}

// the red half from the black one (times its keep kb, or null)
__global__ void cpack_red_kernel(float* __restrict__ r,
                                 const float* __restrict__ b,
                                 const float* __restrict__ kb,
                                 const float* __restrict__ pr, int D, int H,
                                 int Wh, float a, float crec, int neg_mask) {
  cpack_cell<true>(r, b, kb, pr, D, H, Wh, a, crec, neg_mask);
}

// the black half from the red one just written (pre-keep, unmasked)
__global__ void cpack_black_kernel(float* __restrict__ b,
                                   const float* __restrict__ r,
                                   const float* __restrict__ pb, int D, int H,
                                   int Wh, float a, float crec,
                                   int neg_mask) {
  cpack_cell<false>(b, r, nullptr, pb, D, H, Wh, a, crec, neg_mask);
}

dim3 half_grid(int D, int H, int Wh) {
  return dim3(fst::cdiv(Wh, kBlock.x), fst::cdiv(H, kBlock.y), D);
}

}  // namespace

extern "C" {

// The red half-sweep in place on r (D, H, Wh), from the black half b read
// times kb (null: an empty scene) and the red rhs half pr. neg_mask holds
// the field's face signs (field 0 of _build.neg_mask).
int fst_cpack_red(void* r, const void* b, const void* kb, const void* pr,
                  int D, int H, int Wh, float a, float crec, int neg_mask,
                  void* stream) {
  cpack_red_kernel<<<half_grid(D, H, Wh), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(r), static_cast<const float*>(b),
      static_cast<const float*>(kb), static_cast<const float*>(pr), D, H, Wh,
      a, crec, neg_mask);
  return fst::launch_status();
}

// The black half-sweep in place on b, from the red half r and the black
// rhs half pb.
int fst_cpack_black(void* b, const void* r, const void* pb, int D, int H,
                    int Wh, float a, float crec, int neg_mask, void* stream) {
  cpack_black_kernel<<<half_grid(D, H, Wh), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(b), static_cast<const float*>(r),
      static_cast<const float*>(pb), D, H, Wh, a, crec, neg_mask);
  return fst::launch_status();
}

}  // extern "C"
