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
// result equals the plain torch sweep bit for bit. The per-cell body lives
// in common.cuh (rbgs_cell), shared with the cooperative prestep.
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
//
// Three fields in one launch (ROADMAP B16). Replaces
// linsolve_pallas.py::pallas_rbgs_solve3, which ran the step's three
// velocity diffusions (b = 1, 2, 3, one a and c, one shared keep) as three
// packed bodies in one TPU call. Here every launch is a half-sweep of all
// three fields: the grid's z extent is 3*D and blockIdx.z / D picks the
// field, whose face signs are bits 3*field.. of the sign mask. A solve of
// three fields is 2*acc launches (+1 deferred red keep launch) instead of
// three times that. The fields are independent, so each is bitwise the
// single-field solve.
//
// The unpacked form (ROADMAP B21). Replaces pallas_rbgs_solve with
// packed=False (_make_kernel, linsolve_pallas.py:80-135), whose setBounds
// multiplies the whole padded field by the padded keep after every sweep,
// ghosts included (:122-130); the packed form assumes keep is 1 there. keep
// is then the padded (D+2, H+2, W+2) array, contiguous like f. Interior
// cells run the keep form above. A face is written as sign*u and then
// multiplied by keep at the ghost position, as the plain write_faces_ and
// f.mul_(keep) do. Ghost edges and corners, which no stencil reads, are
// multiplied by keep once per sweep in the plain version; one closing launch
// multiplies each of them `acc` times in sequence, which gives the same bits.

#include "common.cuh"

namespace {

// up to three fields of one launch and their right-hand sides
struct Fields {
  float* f[3];
  const float* prev[3];
};

// the colour's cells of padded plane z: (z, y, x) with z+y+x = color
// (mod 2); false for threads past the row's end
__device__ __forceinline__ bool colour_cell(int color, int z, int H, int W,
                                            int& y, int& x) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  if (y > H) return false;
  x = fst::colour_x(color, z, y, t);
  return x <= W;
}

// the field of this block (blockIdx.z / D of NF fields) and its padded
// plane z; one field needs no division
template <int NF>
__device__ __forceinline__ int field_plane(int D, int& z) {
  if (NF == 1) {
    z = blockIdx.z + 1;
    return 0;
  }
  const int field = blockIdx.z / D;
  z = blockIdx.z - field * D + 1;
  return field;
}

template <int NF>
__device__ __forceinline__ float* field_ptr(const Fields& fs, int field) {
  // selects, not a dynamic index into the parameter struct
  return NF == 1 || field == 0 ? fs.f[0] : (field == 1 ? fs.f[1] : fs.f[2]);
}

// the unpacked form's faces: sign*u (x+: u) times keep at the ghost
__device__ __forceinline__ void write_faces_keep(
    float* v, const float* __restrict__ k, long i, long sy, long sz, int z,
    int y, int x, int D, int H, int W, float u, int neg_mask) {
  if (x == 1)
    v[i - 1] =
        __fmul_rn(__fmul_rn(fst::face_sign(neg_mask, 0, 0), u), k[i - 1]);
  if (x == W) v[i + 1] = __fmul_rn(u, k[i + 1]);
  if (y == 1)
    v[i - sy] =
        __fmul_rn(__fmul_rn(fst::face_sign(neg_mask, 0, 1), u), k[i - sy]);
  if (y == H)
    v[i + sy] =
        __fmul_rn(__fmul_rn(fst::face_sign(neg_mask, 0, 1), u), k[i + sy]);
  if (z == 1)
    v[i - sz] =
        __fmul_rn(__fmul_rn(fst::face_sign(neg_mask, 0, 2), u), k[i - sz]);
  if (z == D)
    v[i + sz] =
        __fmul_rn(__fmul_rn(fst::face_sign(neg_mask, 0, 2), u), k[i + sz]);
}

// NF fields in one launch. keep != nullptr: the keep form (black cells
// store u*keep). UNPACKED: keep is the padded keep (indexed like f) and the
// faces are multiplied by it.
template <bool UNPACKED, int NF>
__global__ void rbgs_half_kernel(Fields fs, const float* __restrict__ keep,
                                 int ksz, int ksy, int D, int H, int W,
                                 float a, float crec, int color,
                                 int neg_mask) {
  int z, y, x;
  const int field = field_plane<NF>(D, z);
  if (!colour_cell(color, z, H, W, y, x)) return;
  float* f = field_ptr<NF>(fs, field);
  const float* prev = NF == 1 || field == 0
                          ? fs.prev[0]
                          : (field == 1 ? fs.prev[1] : fs.prev[2]);
  if (!UNPACKED) {
    fst::rbgs_cell(f, prev, keep, ksz, ksy, D, H, W, a, crec, color,
                   neg_mask, field, z, y, x);
    return;
  }
  const long sy = W + 2;
  const long sz = static_cast<long>(H + 2) * (W + 2);
  const long i = z * sz + y * sy + x;
  const float u = fst::rbgs_update(f, prev, i, sy, sz, a, crec);
  f[i] = color == 1 ? __fmul_rn(u, keep[i]) : u;
  write_faces_keep(f, keep, i, sy, sz, z, y, x, D, H, W, u, neg_mask);
}

// the deferred keep multiply of the red cells after the last sweep
template <int NF>
__global__ void keep_red_kernel(Fields fs, const float* __restrict__ keep,
                                int ksz, int ksy, int D, int H, int W) {
  int z, y, x;
  const int field = field_plane<NF>(D, z);
  if (!colour_cell(0, z, H, W, y, x)) return;
  fst::keep_red_cell(field_ptr<NF>(fs, field), keep, ksz, ksy, H, W, z, y, x);
}

// the unpacked form's ghost edges and corners (two or three coordinates on
// the ghost shell): `acc` keep multiplies in sequence, one per sweep
__global__ void keep_edges_kernel(float* f, const float* __restrict__ keep,
                                  int D, int H, int W, int acc) {
  const long n = static_cast<long>(D + 2) * (H + 2) * (W + 2);
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % (W + 2));
  const int y = static_cast<int>((i / (W + 2)) % (H + 2));
  const int z = static_cast<int>(i / (static_cast<long>(W + 2) * (H + 2)));
  const int ghost_axes = (x == 0 || x == W + 1) + (y == 0 || y == H + 1) +
                         (z == 0 || z == D + 1);
  if (ghost_axes < 2) return;
  const float k = keep[i];
  float v = f[i];
  for (int s = 0; s < acc; ++s) v = __fmul_rn(v, k);
  f[i] = v;
}

const dim3 kBlock(32, 8, 1);

dim3 half_grid(int nfields, int D, int H, int W) {
  return dim3(fst::cdiv((W + 1) / 2, kBlock.x), fst::cdiv(H, kBlock.y),
              nfields * D);
}

Fields one_field(void* f, const void* prev) {
  return Fields{{static_cast<float*>(f), nullptr, nullptr},
                {static_cast<const float*>(prev), nullptr, nullptr}};
}

}  // namespace

extern "C" {

// One half-sweep (color 0 = red, 1 = black) of the padded field f in place.
int fst_rbgs_half(void* f, const void* prev, int D, int H, int W, float a,
                  float crec, int color, int neg_mask, void* stream) {
  rbgs_half_kernel<false, 1><<<half_grid(1, D, H, W), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      one_field(f, prev), nullptr, 0, 0, D, H, W, a, crec, color, neg_mask);
  return fst::launch_status();
}

// The keep form of one half-sweep; keep is the interior (D, H, W) view
// with z/y strides ksz/ksy.
int fst_rbgs_half_keep(void* f, const void* prev, const void* keep, int ksz,
                       int ksy, int D, int H, int W, float a, float crec,
                       int color, int neg_mask, void* stream) {
  rbgs_half_kernel<false, 1><<<half_grid(1, D, H, W), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      one_field(f, prev), static_cast<const float*>(keep), ksz, ksy, D, H, W,
      a, crec, color, neg_mask);
  return fst::launch_status();
}

// One half-sweep of three padded fields f0..f2 (right-hand sides p0..p2)
// in place; keep is null (empty form) or the shared interior keep view.
// neg_mask holds the three fields' face signs.
int fst_rbgs_half3(void* f0, void* f1, void* f2, const void* p0,
                   const void* p1, const void* p2, const void* keep, int ksz,
                   int ksy, int D, int H, int W, float a, float crec,
                   int color, int neg_mask, void* stream) {
  const Fields fs{{static_cast<float*>(f0), static_cast<float*>(f1),
                   static_cast<float*>(f2)},
                  {static_cast<const float*>(p0),
                   static_cast<const float*>(p1),
                   static_cast<const float*>(p2)}};
  rbgs_half_kernel<false, 3><<<half_grid(3, D, H, W), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      fs, static_cast<const float*>(keep), ksz, ksy, D, H, W, a, crec, color,
      neg_mask);
  return fst::launch_status();
}

// The unpacked keep form of one half-sweep; keep is the padded keep,
// contiguous, shaped like f.
int fst_rbgs_half_unpacked(void* f, const void* prev, const void* keep, int D,
                           int H, int W, float a, float crec, int color,
                           int neg_mask, void* stream) {
  rbgs_half_kernel<true, 1><<<half_grid(1, D, H, W), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      one_field(f, prev), static_cast<const float*>(keep), 0, 0, D, H, W, a,
      crec, color, neg_mask);
  return fst::launch_status();
}

// f *= keep on the red interior cells (after the last keep half-sweep).
int fst_keep_red(void* f, const void* keep, int ksz, int ksy, int D, int H,
                 int W, void* stream) {
  keep_red_kernel<1><<<half_grid(1, D, H, W), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      one_field(f, nullptr), static_cast<const float*>(keep), ksz, ksy, D, H,
      W);
  return fst::launch_status();
}

// The same on three fields sharing one keep.
int fst_keep_red3(void* f0, void* f1, void* f2, const void* keep, int ksz,
                  int ksy, int D, int H, int W, void* stream) {
  const Fields fs{{static_cast<float*>(f0), static_cast<float*>(f1),
                   static_cast<float*>(f2)},
                  {nullptr, nullptr, nullptr}};
  keep_red_kernel<3><<<half_grid(3, D, H, W), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      fs, static_cast<const float*>(keep), ksz, ksy, D, H, W);
  return fst::launch_status();
}

// The unpacked form's ghost edges and corners times keep, `acc` times.
int fst_keep_edges(void* f, const void* keep, int D, int H, int W, int acc,
                   void* stream) {
  const long n = static_cast<long>(D + 2) * (H + 2) * (W + 2);
  const int block = 256;
  keep_edges_kernel<<<fst::cdiv(n, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(keep), D, H, W, acc);
  return fst::launch_status();
}

const char* fst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
