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
// where it takes one).
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
// PERF.md K11).
//
// The march itself is in rbgs_tile.cuh, which sweepcost.cu shares for the
// sweep-cost variants; this file instantiates only its production form.
//
// Numerics: the neighbour sum is ((((x+ + x-) + y+) + y-) + z+) + z-, the
// update (rhs + a*s) * (1/c), every operation rounded on its own
// (__fmul_rn/__fadd_rn, -fmad=false): equal to the plain torch passes
// (kernels/linsolve_stream.py) bit for bit.

#include "rbgs_tile.cuh"

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
// later; keep (an interior view) or nullptr for an empty scene.
int fst_rbgs_pass(const void* fin, const void* rhs, int rsz, int rsy,
                  const void* keep, int ksz, int ksy, void* out, int D, int H,
                  int W, float a, float crec, int nsw, int neg_mask,
                  void* stream) {
  const bool k = keep != nullptr;
  if (nsw == 1)
    return k ? launch_march<1, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream)
             : launch_march<1, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                             ksy, out, D, H, W, a, crec,
                                             neg_mask, stream);
  if (nsw == 2)
    return k ? launch_march<2, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream)
             : launch_march<2, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                             ksy, out, D, H, W, a, crec,
                                             neg_mask, stream);
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
