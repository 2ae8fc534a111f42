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
// Keep inside a pass. The ring holds pre-keep values u. In the red half a
// red cell reads its black neighbours post-keep, u*keep (relax multiplies
// the whole field by keep after each sweep); in the black half a black cell
// reads its red neighbours' fresh pre-keep updates, as relax does. Solid
// cells are updated like any other and their neighbours read those values.
// The black cells' keep lives in shared memory as one bit a cell, and the
// red half multiplies by it only in planes that hold a black cell whose
// keep is not 1 (rbgs_tile.cuh): so keep must hold only 0.0 and 1.0, as
// every mask of scene/masks.py does (kernels/linsolve_stream.py says so
// where it takes one). A keep pass also takes a table of one byte a block
// (fst_march_table, built once a mask and cached by
// kernels/linsolve_stream.py): a block whose footprint holds no keep other
// than 1, about 95 % of them around the bench's sphere, runs the keep-free
// form, which loads no keep, and computes the same bits.
//
// Design: a 2.5-D z-march ("3.5-D blocking", Nguyen et al., SC'10). A block
// owns a tile of output cells in (x, y) (32 x 32 at nsw 2, 32 x 16 at nsw
// 1) and 32 output planes; it
// loads its tile with a halo of M = 2*nsw cells in x and y only, and
// marches z through a ring of 2*nsw + 3 planes in shared memory: at march
// step j plane j enters the ring and half-sweep h runs on plane j-1-h, so
// the 2*nsw half-sweeps of a pass move through z one plane apart, each
// over an (x, y) region that shrinks one cell a side per half-sweep, and
// plane j - 2*nsw leaves finished. rbgs_tile.cuh has the march step by
// step, the colour-split rows that keep a warp's shared-memory reads
// conflict-free, the staging of rhs and keep, and the face blocks that
// alone splice the domain's x/y faces. The trapezoid of
// linsolve_mdma.py:233-238 (red extension 2(nsw-s)+1, black one cell
// inside it) is paid in x and y and only at the ends of a block's z-range.
// Blocks run in no order, so a pass reads one buffer and writes another,
// never in place. Parity comes from global packed coordinates: red cells
// have an odd packed sum (an even 1-based one). Offsets into the fields
// are 64-bit.
//
// It replaces a 3-D tile kernel (32 x 8 x 8 outputs, halo M on all six
// sides) that recomputed 2.21 updates per needed update at nsw 2, loaded
// 5.00 tile cells per output cell, stepped 2 words a lane through shared
// memory, and decoded, domain-tested and spliced every update in every
// block: it ran at about 14 % of its bound (PERF.md, K11). The march makes
// 1.31 updates per needed update at nsw 2 (1.20 in x and y, 1.09 in z) and
// loads 1.95 cells per output cell.
//
// What bounds it on the H100. Its floor is memory traffic: a pass must read
// fpre and the rhs (and keep) once and write fpre once, two sweeps per pass
// over the data with nsw = 2, against one read of the field and prev per
// half-sweep for the resident kernel (rbgs.cu), whose padded field no longer
// fits the L2 at 256^3 (69 MB) and 512x256x256 (137 MB). The flops (8 per
// cell update, 1.3x recomputed) are far under the f32 rate; the issue rate
// of its shared-memory reads (7 a cell update) and the barrier after each
// half-sweep are what it spends over the bytes (chip_smoke.py prints the
// per-call times and bounds).
//
// Residency on the H100 (ptxas -v, -O3 -fmad=false; no form spills; the
// blocks an SM that fst_march_blocks_per_sm reads on the card):
//   form                    threads  registers  shared B   blocks an SM
//   sweep 1 (nsw 1, padded)     192         96    30,720              3
//   pass nsw 1                  192         61    30,720              5
//   pass nsw 1, keep            192         80    34,096              4
//   pass nsw 2                  416         72    89,600              2
//   pass nsw 2, keep            416         72    96,160              2
// The keep forms load their planes coalesced, by cp.async, and keep no
// copy of the black cells' u*keep: their ring no longer holds 22.4 KB a
// block of it (112,000 B), so two keep blocks fit the 196 KB carveout and
// leave 60 KB of L1, as the empty form's do, where the 228 KB one left 28
// (a keep pass at 512x256x256: 0.476 ms before, 0.427-0.432 after;
// PERF.md K11). A keep kernel holds the keep-free form beside its own, for
// the blocks its table clears, in the same registers (a branch at a
// block's entry, no spill); the table kernel takes 34 registers.
//
// The march itself is in rbgs_tile.cuh, which sweepcost.cu shares for the
// sweep-cost variants; this file instantiates only its production form and,
// inside the keep kernels, the keep-free form (kCoalesced).
//
// Numerics: the neighbour sum is ((((x+ + x-) + y+) + y-) + z+) + z-, the
// update (rhs + a*s) * (1/c), every operation rounded on its own
// (__fmul_rn/__fadd_rn, -fmad=false): equal to the plain torch passes
// (kernels/linsolve_stream.py) bit for bit.

#include "rbgs_tile.cuh"

namespace {

constexpr int kTableThreads = 256;

// The table of the keep passes at depth NSW: block (bx, by, bz) of the
// pass's grid reads its footprint, rows [y0, y0 + LY) and columns
// [x0, x0 + L) of planes [zlo, zhi] clipped to the domain (a warp a row),
// and writes 1 where any keep there is not 1. Once a mask: a pass reads
// the table, never the mask, to choose its form.
template <int NSW>
__global__ void __launch_bounds__(kTableThreads)
    march_table_kernel(const float* keep, int ksz, int ksy, int D, int H,
                       int W, unsigned char* table) {
  using G = March<NSW>;
  const int x0 = blockIdx.x * kTx - G::M, y0 = blockIdx.y * kTy<NSW> - G::M;
  const int zs = blockIdx.z * kChunk, ze = min(zs + kChunk, D);
  const int zlo = max(zs - G::M, 0), zhi = min(ze + G::M - 1, D - 1);
  const int xlo = max(x0, 0), nx = min(x0 + G::L, W) - xlo;
  const int ylo = max(y0, 0), ny = min(y0 + G::LY, H) - ylo;
  const int rows = ny * (zhi - zlo + 1);
  bool solid = false;
  for (int r = threadIdx.x / 32; r < rows; r += kTableThreads / 32) {
    const int z = zlo + r / ny, y = ylo + r % ny;
    const float* row = keep + static_cast<long>(z) * ksz +
                       static_cast<long>(y) * ksy + xlo;
    for (int x = threadIdx.x % 32; x < nx; x += 32)
      solid |= row[x] != 1.0f;
  }
  solid = __syncthreads_or(solid);
  if (threadIdx.x == 0)
    table[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        solid;
}

template <int NSW>
int launch_table(const void* keep, int ksz, int ksy, int D, int H, int W,
                 void* table, void* stream) {
  const dim3 grid(fst::cdiv(W, kTx), fst::cdiv(H, kTy<NSW>),
                  fst::cdiv(D, kChunk));
  march_table_kernel<NSW><<<grid, kTableThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keep), ksz, ksy, D, H, W,
      static_cast<unsigned char*>(table));
  return fst::launch_status();
}

}  // namespace

extern "C" {

// Sweep 1: the padded field (its ghost faces as the caller left them) and
// the interior rhs view -> the packed pre-keep field after one sweep.
int fst_rbgs_sweep1(const void* field, const void* rhs, int rsz, int rsy,
                    void* out, int D, int H, int W, float a, float crec,
                    void* stream) {
  return launch_march<1, false, true>(field, rhs, rsz, rsy, nullptr, 0, 0,
                                      out, D, H, W, a, crec, 0, stream);
}

// One pass: the packed pre-keep carry -> the carry nsw (1 or 2) sweeps
// later; keep (an interior view) or nullptr for an empty scene. With keep,
// table is fst_march_table's table of this keep view at this nsw.
int fst_rbgs_pass(const void* fin, const void* rhs, int rsz, int rsy,
                  const void* keep, int ksz, int ksy, void* out, int D, int H,
                  int W, float a, float crec, int nsw, int neg_mask,
                  const void* table, void* stream) {
  const bool k = keep != nullptr;
  if (k && table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (nsw == 1)
    return k ? launch_march<1, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream, table)
             : launch_march<1, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                             ksy, out, D, H, W, a, crec,
                                             neg_mask, stream);
  if (nsw == 2)
    return k ? launch_march<2, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream, table)
             : launch_march<2, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                             ksy, out, D, H, W, a, crec,
                                             neg_mask, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The keep passes' table (rbgs_tile.cuh, "Keep-free blocks") of an interior
// keep view at pass depth nsw (1 or 2): one byte a block of the pass's grid,
// 1 where a cell of the block's footprint has a keep other than 1, else 0.
int fst_march_table(const void* keep, int ksz, int ksy, int D, int H, int W,
                    int nsw, void* table, void* stream) {
  if (nsw == 1)
    return launch_table<1>(keep, ksz, ksy, D, H, W, table, stream);
  if (nsw == 2)
    return launch_table<2>(keep, ksz, ksy, D, H, W, table, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of one form of the march that an SM of the current device
// holds at once, with the dynamic shared memory it launches with, into
// *blocks: sweep 1 (nsw 1, no keep, padded) or a pass (nsw 1 or 2, keep or
// not). A query for the probes and the card tests; no step calls it.
int fst_march_blocks_per_sm(int nsw, int keep, int padded, int* blocks) {
  if (padded)
    return nsw == 1 && !keep ? march_blocks<1, false, true>(blocks)
                             : static_cast<int>(cudaErrorInvalidValue);
  if (nsw == 1)
    return keep ? march_blocks<1, true, false>(blocks)
                : march_blocks<1, false, false>(blocks);
  if (nsw == 2)
    return keep ? march_blocks<2, true, false>(blocks)
                : march_blocks<2, false, false>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
