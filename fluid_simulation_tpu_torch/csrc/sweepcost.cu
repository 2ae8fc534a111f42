// The sweep-cost variants of the streamed pass kernel: rbgs_stream.cu's
// empty-scene pass (rbgs_tile.cuh) with one mechanism removed at a time, so
// that the time each mechanism costs is the difference to `full`.
//
// Replaces the kernel of tools/exp_sweepcost.py (`make` :53, pallas_call
// :114, ROADMAP B23), which degraded the TPU's packed 1-sweep stream kernel
// the same way to split its time. The TPU's variants name the TPU kernel's
// mechanisms; each maps onto the Hopper kernel's own:
//
//   TPU      removed there                    removed here (rbgs_tile.cuh)
//   full     nothing                          nothing: the production pass
//   nosel    parity and edge selects, every   the six domain-edge splices;
//            cell updated                     a neighbour outside the domain
//                                             is read from the tile (zeros)
//   noiota   the iotas, parity and edge       the per-update domain test
//            masks; plain rolls and z slices  (cells outside the domain are
//                                             updated too, rhs read at the
//                                             clamped coordinate)
//   noroll   the x/y rolls (s = 4f + z)       the x/y neighbour reads
//   nozn     the z-neighbour row slices       the z neighbour reads
//   arith    everything but (rhs + a*6f)*crec every neighbour read and the
//                                             colours: (rhs + a*(6u))*crec
//                                             on every cell of each region
//
// Why not literally. On the TPU a half-sweep computes every cell with
// whole-array operations and keeps its colour with a select, so "update
// every cell" was free to try. Here a half-sweep's threads visit only the
// cells of its colour, and a cell updated in place while its neighbours are
// read would race: nosel and noiota keep the colours, and only arith, whose
// update reads no neighbour, updates both. The TPU built index arrays
// (iotas) for every cell; the Hopper kernel's counterpart is each update's
// decode of its loop counter into tile coordinates, which the colour
// structure needs and which divides by compile-time constants. What noiota
// removes is the rest of the per-update index work, the domain test and
// its branch. Its result is full's (the splices never read a cell outside
// the domain), so it is the one variant whose numbers are right.
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
    return launch_tile<1, false, false, V>(fin, rhs, rsz, rsy, nullptr, 0, 0,
                                           out, D, H, W, a, crec, neg_mask,
                                           stream);
  if (nsw == 2)
    return launch_tile<2, false, false, V>(fin, rhs, rsz, rsy, nullptr, 0, 0,
                                           out, D, H, W, a, crec, neg_mask,
                                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One empty-scene pass of nsw (1 or 2) sweeps of the packed carry, with the
// mechanisms of `variant` (0 full, 1 nosel, 2 noiota, 3 noroll, 4 nozn,
// 5 arith) removed; refuses anything else with cudaErrorInvalidValue.
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
