// The sweep-cost variants of the streamed pass kernel: rbgs_stream.cu's
// empty-scene pass (the z-march of rbgs_tile.cuh) with one mechanism
// removed at a time, so that the time each mechanism costs is the
// difference to `full`.
//
// Replaces the kernel of tools/exp_sweepcost.py (`make` :53, pallas_call
// :114, ROADMAP B23), which degraded the TPU's packed 1-sweep stream kernel
// the same way to split its time. The TPU's variants name the TPU kernel's
// mechanisms; each maps onto the Hopper march's own:
//
//   TPU      removed there                    removed here (rbgs_tile.cuh)
//   full     nothing                          nothing: the production pass
//   nosel    parity and edge selects, every   the face splices, which only
//            cell updated                     face blocks (ring plane past
//                                             the domain's x/y faces) and
//                                             the planes gz 0 and D-1 make;
//                                             a face cell reads the zeros
//                                             the ring holds outside the
//                                             domain, planes -1 and D too
//   noiota   the iotas, parity and edge       the domain test of face
//            masks; plain rolls and z slices  blocks' updates (their cells
//                                             outside the domain are
//                                             updated too, from rhs 0)
//   noroll   the x/y rolls (s = 4f + z)       the four x/y reads of the
//                                             colour-split rows (the other
//                                             half at k+off, k+off-1 and
//                                             rows ±1)
//   nozn     the z-neighbour row slices       the two z reads (the other
//                                             half of ring planes q±1)
//   arith    everything but (rhs + a*6f)*crec every neighbour read and the
//                                             colours: (rhs + a*(6u))*crec
//                                             on both cells of each pair in
//                                             each region, from the staged
//                                             rhs
//
// and one variant of this port's own, which removes nothing:
//   coalesced  the plane loads of the keep forms (rbgs_tile.cuh's fetch
//              and land: a warp's 32 consecutive cells by cp.async, straight
//              into the ring) in place of a quad a thread through registers;
//              its time against full is what those loads would give the
//              empty forms, which keep theirs
//
// What stays in every variant: the march (one plane loaded into registers
// and written into the ring a step, rhs staged beside it, a barrier after
// each half-sweep, the final plane stored), the shrinking regions and the
// pair decode, which a thread computes once for the whole march.
//
// Why not literally. On the TPU a half-sweep computes every cell with
// whole-array operations and keeps its colour with a select, so "update
// every cell" was free to try. Here a half-sweep's threads visit only the
// cells of its colour, and a cell updated in place while its neighbours are
// read would race: nosel and noiota keep the colours, and only arith, whose
// update reads no neighbour, updates both. noiota's result is full's (the
// splices never read a cell outside the domain), so it is the one variant
// whose numbers are right.
//
// Each variant computes a stated function (kernels/sweepcost.py
// sweep_pass_variant_plain) and is bitwise to it: every operation rounded
// on its own, -fmad=false.

#include "rbgs_tile.cuh"

namespace {

template <int V>
int launch_variant(const void* fin, const void* rhs, int rsz, int rsy,
                   void* out, int D, int H, int W, float a, float crec,
                   int nsw, int neg_mask, void* stream) {
  if (nsw == 1)
    return launch_march<1, false, false, V>(fin, rhs, rsz, rsy, nullptr, 0, 0,
                                            out, D, H, W, a, crec, neg_mask,
                                            stream);
  if (nsw == 2)
    return launch_march<2, false, false, V>(fin, rhs, rsz, rsy, nullptr, 0, 0,
                                            out, D, H, W, a, crec, neg_mask,
                                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One empty-scene pass of nsw (1 or 2) sweeps of the packed carry, with the
// mechanisms of `variant` (0 full, 1 nosel, 2 noiota, 3 noroll, 4 nozn,
// 5 arith) removed, or (6 coalesced) with the keep forms' plane loads;
// refuses anything else with cudaErrorInvalidValue.
int fst_sweepcost_pass(const void* fin, const void* rhs, int rsz, int rsy,
                       void* out, int D, int H, int W, float a, float crec,
                       int nsw, int neg_mask, int variant, void* stream) {
  switch (variant) {
    case kFull:
      return launch_variant<kFull>(fin, rhs, rsz, rsy, out, D, H, W, a, crec,
                                   nsw, neg_mask, stream);
    case kNoSel:
      return launch_variant<kNoSel>(fin, rhs, rsz, rsy, out, D, H, W, a,
                                    crec, nsw, neg_mask, stream);
    case kNoIota:
      return launch_variant<kNoIota>(fin, rhs, rsz, rsy, out, D, H, W, a,
                                     crec, nsw, neg_mask, stream);
    case kNoRoll:
      return launch_variant<kNoRoll>(fin, rhs, rsz, rsy, out, D, H, W, a,
                                     crec, nsw, neg_mask, stream);
    case kNoZn:
      return launch_variant<kNoZn>(fin, rhs, rsz, rsy, out, D, H, W, a, crec,
                                   nsw, neg_mask, stream);
    case kArith:
      return launch_variant<kArith>(fin, rhs, rsz, rsy, out, D, H, W, a,
                                    crec, nsw, neg_mask, stream);
    case kCoalesced:
      return launch_variant<kCoalesced>(fin, rhs, rsz, rsy, out, D, H, W, a,
                                        crec, nsw, neg_mask, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
