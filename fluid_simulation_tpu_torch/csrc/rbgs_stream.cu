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
// The tile kernel itself is in rbgs_tile.cuh, which sweepcost.cu shares for
// the sweep-cost variants; this file instantiates only its production form.
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
  return launch_tile<1, false, true>(field, rhs, rsz, rsy, nullptr, 0, 0,
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
    return k ? launch_tile<1, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                           ksy, out, D, H, W, a, crec,
                                           neg_mask, stream)
             : launch_tile<1, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream);
  if (nsw == 2)
    return k ? launch_tile<2, true, false>(fin, rhs, rsz, rsy, keep, ksz,
                                           ksy, out, D, H, W, a, crec,
                                           neg_mask, stream)
             : launch_tile<2, false, false>(fin, rhs, rsz, rsy, keep, ksz,
                                            ksy, out, D, H, W, a, crec,
                                            neg_mask, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
