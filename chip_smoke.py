#!/usr/bin/env python3
"""Drive the PyTorch port of the wind tunnel on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero without the
final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of the CUDA kernels from ``fluid_simulation_tpu_torch/csrc``;
2. each kernel against its plain torch version on the card, at the
   128x64x64 flagship shapes and at an odd small shape, random inputs from
   a NumPy seed: bitwise equality expected. The obstacle kernels take the
   bench sphere's masks at 128x64x64 and a random 0/1 obstacle field at
   13x7x5. Each kernel's time, its plain version's, and its bound (the
   bytes it must move at 3.35 TB/s or its f32 operations at 67 TFLOP/s,
   whichever is larger) at the flagship shapes. The padding kernel (K4,
   K4 masked) is held to its plain version bit for bit (a zero's sign
   too), also at ``RAGGED_PAD``: D, H or W 1, and W under and just over
   a warp's chunk of x positions, for 1, 2 and 3 fields, both walls,
   masked (interior views of padded masks) and not;
3. the streamed big-grid kernels (rbgs_sweep1, rbgs_pass at nsw 1 and 2
   with and without keep, div_packed, grad_packed) against their plain
   versions, bitwise, at 256x128x128 with the bench sphere's masks and at
   an odd 13x7x10 with random 0/1 solids and no-slip walls (ragged tiles);
   the keep passes' tables of keep-free blocks (``keep_vel`` and
   ``fluid_i``, nsw 1 and 2) byte for byte against ``march_table_plain``;
   the streamed solve and projection wrappers against their plain versions
   (nsw 2 and 1, an odd acc) and against the resident route (K1, K1 keep,
   K2 + tail, K6 + tail) for b = 0..3; their times and bounds; then the
   pass kernel's z-march where it can go wrong (``RAGGED``: D 1, 2, 3 and
   5 under its ring and warm-up, D one past a z-range, H and W under the
   tile, a grid with face and interior blocks): sweep 1 and the pass at
   nsw 1 and 2, keep and empty, b = 0..3, both walls, bitwise;
4. the split flagship: ``WindTunnel(SimParams(mode="split", ...),
   device="cuda").simulate(100)`` — finite, density > 0, divergence
   residual max < 20 and mean < 1 (bench.py's bounds), kernel launch
   counts 3/2/2/2 per step; then 3 more steps on the kernel path and on the
   plain path (``use_pallas=False``) from the same state, which must agree;
5. compat parity: 100 default compat steps at 128x64x64 against the
   reference's own print (density sum 14125.1 within 1.5 %, max 0.0505
   within 2 %), launch counts 3/2 solves/projections and 4 whole advects
   (K19) per step;
6. the bench's sphere (bench.py:224-226) in split for 100 steps and in
   compat for 20, and the reference main()'s STL scene (the repo's
   icosphere, rotated and translated as main() does, at scale 0.5) in split
   for 100: the obstacle kernels' launch counts, the residual bounds, every
   solid cell exactly 0, a density sum that differs from the empty run's,
   and the kernel path equal to the plain path over 3 (compat: 2) steps;
7. no-slip walls with vorticity 5.0 (bench.py:227-228) in split for 100
   steps: launch counts, residual bounds, kernel path equal to plain;
8. the bench's six big configs (bench.py:227-263) through
   ``WindTunnel(...).simulate``: 256x128x128 for 10 steps, 256^3 for 4,
   512x256x256 for 3, each empty and with its sphere. Launch counts per
   step prove the streamed route ran (3 streamed solves, 2 streamed
   projections, 2 advections, 4 paddings; with the sphere 37 keep passes,
   and 3 tables of their keep-free blocks in the run, which equal
   ``march_table_plain``'s at both depths); the residual bounds; solids
   exactly 0; each sphere's density sum differs from its empty twin's; at
   256x128x128 one step of the kernel path equals the plain path; the
   density sums exactly (repr), to hold against another tree's; ms/step;
9. per call at each big shape, both routes of the solve and of the
   projection (resident and streamed, in turns), and K4 / K4 masked
   against their plain versions at 512x256x256 (K7, the streamed route's
   padding), each with its time beside its bound and its share of it;
10. the variant kernels against their plain versions, bitwise: the
    trilinear gather (K9) at 128x64x64 on random backtraces reaching 10+
    cells and on a sphere state after 20 compat steps, beside
    ``torch.nn.functional.grid_sample`` (the one PyTorch call that samples
    trilinearly; its time and its difference, never 0), and both on the
    random backtraces as CUDA-graph replays (device time); the fused
    three-field solve (K5) empty, with keep and with no-slip walls, also
    against three K1 calls; K1 unpacked with a random keep that is 0 on
    parts of the ghost shell; the fused-backtrace split advection (K8) on
    a stack of 3. Their times and bounds; then K19, a whole compat advect
    in one launch (``advect_compat``), against the plain call bitwise at
    ragged shapes (b 0-3, both walls, empty and with solids, backtraces
    clamped at every face and on exact integers) and at 512x256x256 and
    128x64x64 with their spheres: its event time beside the plain call's,
    its bound, its device time by CUDA-graph replay; then K20, fast's
    shared backtrace and three velocity samples in one launch
    (``advect_fast``), against the plain composition bitwise at ragged
    shapes (backtraces clamped at every face and on exact integers) and at
    512x256x256 and 128x64x64 with their spheres: its device time by
    CUDA-graph replay and its share of the bound, its event time beside
    the plain composition's;
11. compat with ``advect_window=1`` for 100 steps: the parity gate, 3/2/4
    solves/projections/whole advects (K19, whatever the window) per step,
    the final state bitwise equal to the window-0 run's, ms/step of both;
    its sphere twin for 20 steps (solids exactly 0, equal to the window-0
    twin);
12. fast with ``advect_window=1`` against fast without, 100 steps: one
    K20 launch (the velocity) and one whole density advect (K19) per step,
    no trilinear gather (K9), bitwise equal states, the residual bounds,
    ms/step of both;
13. the sharded solve's sweep kernels (B15 packed, B20 padded) against
    their plain versions, bitwise, on the 256^3 slab of two ranks
    (128x256x256), the 128x64x64 slab of two (32x64x128) and a ragged
    4x7x13 slab, with the bench spheres' keep masks, random 0/1 solids and
    no-slip walls; their times and bounds at the 256^3 slab;
14. ``ShardedWindTunnel(..., devices=["cuda:0"] * n)``, every rank on the
    one card: 256^3 split over 2 slabs for 4 steps, empty and with the
    bench sphere (150 packed sweeps per step and no other kernel, residual
    bounds, solids exactly 0, the obstacle-blind guard, within
    5e-5·max|field| of the single-card streamed run from rest, ms/step);
    128x64x64 compat over 2 slabs for 100 steps through the parity gate;
    128x64x64 split with the bench sphere over 4 slabs for 20 steps
    against the single-card run; one step of the kernel path against
    ``use_pallas=False``, bitwise;
15. the retired kernels of ``tools/`` (``retired_kernels``): one call each
    of the fused prestep (B22a), empty and with the bench sphere, and of
    the blocked solve (B22c), with the counts set to 0 just before and read
    just after (1, 1 and ``acc``, no other counter); the prestep against
    its plain version and against the chain it replaces (K1 x3 + K2, K1
    keep x3 + K6), bitwise, reference and no-slip walls, one device
    operation per call, its event and device ms per call beside the
    chain's and its bound; the blocked solve against its plain version,
    bitwise, at 128x64x64 and 256^3 with the spheres' keep masks, its
    times and bound;
16. the colour-packed solve (B22b, ``cpack``): one call of each entry
    point with the counts set to 0 just before and read just after (the
    resident solve with the bench sphere's keep: one K1 keep solve and one
    ``rbgs_solve_cpack``; the streamed one at acc 15: one blocked sweep
    and 14 ``rbgs_solve_cpack_stream``); at 128x64x64 with the bench
    sphere, 256x64x64 with a sphere at the same place along the tunnel
    and 256^3 with its sphere, b = 0..3, keep and empty scene, reference
    and no-slip walls: each entry point against its plain version, the
    other entry point and K1, bitwise; per call at each shape its event
    and device ms, device ops and bound beside K1 keep's;
17. the launch-overhead probe (B23's ``exp_overhead``, ``overhead``): the
    tiny kernel against its plain version, bitwise; one eager iteration of
    every probe row with the counts set to 0 just before and read just
    after; then every row eager and replayed from a CUDA graph (replay
    bitwise to eager), n = 50, in µs per iteration; then the host split
    of one ``add_one`` and one K9 call at 128x64x64 into the parts of
    ``_build.launch`` and its wrapper;
18. the streaming-ceiling and sweep-cost probes (B23's ``exp_hbm``,
    ``exp_hbm2``, ``exp_sweepcost``, ``streamcost``): one call each of the
    stream kernel and of a sweep-cost variant with the counts set to 0 just
    before and read just after (1 and 1, nothing else); every form of the
    variant at nsw 1 and 2 against its plain version, and ``full`` against
    the production pass, bitwise, at a ragged 13x7x10 and at 256^3; all
    eight of the tools' stream forms (copy1, copy1_blk32, copy2, copy2h,
    sweepish on one operand; copy2d, copy2hd, arithd on two) bitwise at
    13x7x10 (one cell a thread), 16x8x40 (16-byte vectors, a ragged last
    z-block), the same with misaligned operands, and 256^3; then the three
    probes' rows at 256^3 and ``exp_sweepcost``'s at 512x256x256, CUDA-graph
    replays;
19. the DMA-issue, transpose and tensor-core probes (B23's ``exp_dma``,
    ``exp_transpose``, ``exp_solve_mxu``, ``probes_last``): one call each of
    the stream, the transpose, the strided copy, K3's single pass and the
    tensor-core solve with the counts set to 0 just before and read just
    after (1 each, nothing else); every form of the stream (copy2 and
    copy2h with both loaders, manual2) in f32 and bf16 at blk 3 (copy2's
    ragged z-block end), 8 and 16 against its plain version, bitwise, at
    48x19x200, a ragged 40x7x13 (ldg), a ragged 72x9x37 and 256^3; the
    tensor-map cache (two pairs of one shape, the first again, a new
    pair); the transposes at every shape of the JAX probes and of the
    boundary rows, the strided copy's three paths and every merge and
    fallback case (the path each view takes checked), the y pass by
    transposes against K3's direct y pass; the solve at 128x64x64 and an
    odd 13x7x5 against its plain version and K1 unpacked; their times and
    bounds, store_strided beside ``a * 2``; then the three probes at 256^3
    (dma, boundary; probe3's bytes-bound view), their own shapes and
    128x64x64 (mxu);
20. the degrade variants of K3's stacked x pass (B24's ``exp_lerpcost``,
    ``lerpcost``): one call with the counts set to 0 just before and read
    just after (1, nothing else), on a ragged (3, 37, 200) stack with a
    (37, 198) index plane over [-1, 200] and at 256^3 x-geometry (3 x
    258^2 x 258, Co 256); every variant against its plain version,
    bitwise, on the ragged stack and on a seeded random 256^3 stack with
    the tool's plane (77.3) and a random one over [0, C-1]; K3's own x
    pass at that geometry; ``full``'s times and bound (478.7 MB) on the
    random stack and plane, and ``torch.nn.functional.grid_sample``
    beside it, held to ``full`` within 1e-3; then the probe's rows at
    256^3 (the tool's constant stack 0.5);
21. the step's statistics (``stats``): the kernel against its plain
    version at 128x64x64 and 512x256x256, empty and with the bench sphere,
    max_divergence bitwise, the density sum within 2e-6 of a float64 sum
    and the same bits over 5 calls, statistics that are off NaN, a NaN or
    inf velocity cell a non-finite max_divergence, its time beside the
    plain version's and its bound; a split sphere run with both
    statistics on, one ``step_stats`` launch a step, its statistics
    against the plain path's over 3 steps;
22. ms/step of the kernel path and the plain path, timed with CUDA events.

``--only PHASE ...`` runs the build and the named phases (keys in
``PHASES``) and prints no result lines.

Needs torch with CUDA and ``nvcc`` (``CUDA_HOME`` or ``PATH``); imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

SEED = 1234
RESIDUAL_MAX, RESIDUAL_MEAN = 20.0, 1.0          # bench.py:114-115
REF_SUM, REF_MAX = 14125.1, 0.0505               # simulation.cpp:73-90 print
SUM_BAND, MAX_BAND = 0.015, 0.02                 # bench.py:194-195
# one H100 SXM: HBM rate and f32 rate outside the tensor cores (NVIDIA's
# data sheet, at the 700 W limit)
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
# (D, H, W) of the padding kernel's ragged rows: one-cell axes, and x
# extents under and just over a warp's chunk of x positions (a lane
# carries 4, 8 or 16 by W; 600 takes two chunks of 512)
RAGGED_PAD = ((1, 1, 1), (3, 5, 7), (5, 3, 130), (2, 3, 600))
# the reference main()'s scene (SURVEY.md:123-128) with the repo's mesh at
# scale 0.5, where it fits the 128x64x64 tunnel's cross-section
STL_SCENE = dict(stl_path="tests/golden/icosphere_r10.stl", scale=0.5,
                 rot_x=90, translate_x=-16, voxelizer="rasterize")

KERNELS = {
    "rbgs_solve": ("fluid_simulation_tpu_torch/csrc/rbgs.cu",
                   "fluid_simulation_tpu/kernels/linsolve_pallas.py:287"),
    "project_empty": ("fluid_simulation_tpu_torch/csrc/project.cu",
                      "fluid_simulation_tpu/kernels/project_pallas.py:350"),
    "advect_split": ("fluid_simulation_tpu_torch/csrc/advect_split.cu",
                     "fluid_simulation_tpu/kernels/advect_pallas.py:611"),
    "pad_bounds": ("fluid_simulation_tpu_torch/csrc/pad_bounds.cu",
                   "fluid_simulation_tpu/kernels/bounds_pallas.py:257"),
    # the apply_keep branch of the same pallas_call (_packed_body, :185)
    "rbgs_solve_keep": ("fluid_simulation_tpu_torch/csrc/rbgs.cu",
                        "fluid_simulation_tpu/kernels/linsolve_pallas.py:287"),
    "project_masked": ("fluid_simulation_tpu_torch/csrc/project.cu",
                       "fluid_simulation_tpu/kernels/project_pallas.py:323"),
    "pad_bounds_masked": ("fluid_simulation_tpu_torch/csrc/pad_bounds.cu",
                          "fluid_simulation_tpu/kernels/bounds_pallas.py:257"),
    "confinement": ("fluid_simulation_tpu_torch/csrc/vorticity.cu",
                    "fluid_simulation_tpu/kernels/vorticity_pallas.py:103"),
    # the big-grid route: sweep 1 + passes (the merged-window pass B9, which
    # the JAX package routes every empty big grid and the masked 256x128x128
    # and 512x256x256 to), the streamed projections B13 and B14
    "rbgs_solve_stream": ("fluid_simulation_tpu_torch/csrc/rbgs_stream.cu",
                          "fluid_simulation_tpu/kernels/linsolve_mdma.py:287"),
    "rbgs_solve_stream_keep": (
        "fluid_simulation_tpu_torch/csrc/rbgs_stream.cu",
        "fluid_simulation_tpu/kernels/linsolve_mdma.py:287"),
    "project_stream": ("fluid_simulation_tpu_torch/csrc/project_stream.cu",
                       "fluid_simulation_tpu/kernels/project_stream.py:208"),
    "project_stream_masked": (
        "fluid_simulation_tpu_torch/csrc/project_stream.cu",
        "fluid_simulation_tpu/kernels/project_stream.py:504"),
    # the trilinear sample with a window (B19); no route since K20 took
    # fast's velocity
    "trilinear_gather": ("fluid_simulation_tpu_torch/csrc/trilinear.cu",
                         "fluid_simulation_tpu/kernels/advect_compat.py:150"),
    # the variants (B16, B21, B18): gated off, never routed, opt-in in the
    # JAX package; K8 shares K3's pass kernel
    "rbgs_solve3": ("fluid_simulation_tpu_torch/csrc/rbgs.cu",
                    "fluid_simulation_tpu/kernels/linsolve_pallas.py:351"),
    "rbgs_solve_unpacked": (
        "fluid_simulation_tpu_torch/csrc/rbgs.cu",
        "fluid_simulation_tpu/kernels/linsolve_pallas.py:80"),
    "advect_split_fused": (
        "fluid_simulation_tpu_torch/csrc/advect_split.cu",
        "fluid_simulation_tpu/kernels/advect_pallas.py:337"),
    # the sharded solve's per-slab sweeps (B15 routed, B20 never routed)
    "rbgs_sweep_packed": ("fluid_simulation_tpu_torch/csrc/rbgs_sweep.cu",
                          "fluid_simulation_tpu/kernels/linsolve_sweep.py:258"),
    "rbgs_sweep": ("fluid_simulation_tpu_torch/csrc/rbgs_sweep.cu",
                   "fluid_simulation_tpu/kernels/linsolve_sweep.py:144"),
    # the retired kernels of tools/ (B22a, B22c): library functions, no route
    "prestep": ("fluid_simulation_tpu_torch/csrc/prestep.cu",
                "tools/prestep_pallas.py:176"),
    "prestep_masked": ("fluid_simulation_tpu_torch/csrc/prestep.cu",
                       "tools/prestep_pallas.py:176"),
    "rbgs_solve_blocked": ("fluid_simulation_tpu_torch/csrc/rbgs_sweep.cu",
                           "tools/linsolve_blocked.py:180"),
    # B22b: one pair of half-sweep kernels for both TPU entry points
    "rbgs_solve_cpack": ("fluid_simulation_tpu_torch/csrc/rbgs_cpack.cu",
                         "tools/linsolve_cpack.py:206"),
    "rbgs_solve_cpack_stream": (
        "fluid_simulation_tpu_torch/csrc/rbgs_cpack.cu",
        "tools/linsolve_cpack.py:504"),
    # B23: the launch-overhead probe's tiny kernel
    "probe_add1": ("fluid_simulation_tpu_torch/csrc/probe.cu",
                   "tools/exp_overhead.py:53"),
    # B23: the streaming-ceiling probes' stream (row: copy2d) and the
    # sweep-cost variants of the streamed pass (row: full at nsw 2)
    "hbm_stream": ("fluid_simulation_tpu_torch/csrc/hbm.cu",
                   "tools/exp_hbm.py:76"),
    "sweepcost_pass": ("fluid_simulation_tpu_torch/csrc/sweepcost.cu",
                       "tools/exp_sweepcost.py:114"),
    # B23: the DMA-issue probe's stream (row: copy2[tma] at 256^3), the
    # transpose probe's two kernels (rows: the boundary stack's transpose,
    # swap01), K3's single pass (the boundary rows reach lane_lerp_stack;
    # row: the y pass on the pre-transposed stack) and the tensor-core
    # solve (row: 128x64x64, acc 15)
    "dma_stream": ("fluid_simulation_tpu_torch/csrc/dma.cu",
                   "tools/exp_dma.py:99"),
    "transpose": ("fluid_simulation_tpu_torch/csrc/transpose.cu",
                  "tools/exp_transpose.py:62"),
    "strided_copy": ("fluid_simulation_tpu_torch/csrc/transpose.cu",
                     "tools/exp_transpose.py:140"),
    "lerp_pass": ("fluid_simulation_tpu_torch/csrc/advect_split.cu",
                  "fluid_simulation_tpu/kernels/advect_pallas.py:190"),
    "rbgs_solve_mxu": ("fluid_simulation_tpu_torch/csrc/rbgs_mxu.cu",
                       "tools/exp_solve_mxu.py:92"),
    # B24: the degrade variants of K3's stacked x pass (row: full at 256^3
    # on the random index plane)
    "lerpcost_pass": ("fluid_simulation_tpu_torch/csrc/lerpcost.cu",
                      "tools/exp_lerpcost.py:29"),
    # the step's statistics: no TPU kernel, XLA's fused glue in the JAX
    # step (row: 512x256x256 with the bench sphere)
    "step_stats": ("fluid_simulation_tpu_torch/csrc/stats.cu",
                   "none (XLA glue, fluid_simulation_tpu/models/"
                   "windtunnel.py:403-413)"),
    # a whole compat advect: the XLA backtrace, K9's corner fetch (or the
    # XLA gather) and XLA's setBounds fused (row: 512x256x256, the bench
    # sphere, a velocity call)
    "advect_compat": ("fluid_simulation_tpu_torch/csrc/advect_compat.cu",
                      "fluid_simulation_tpu/ops/advect.py:105 with "
                      "fluid_simulation_tpu/kernels/advect_compat.py:150"),
    # fast's velocity: the XLA backtrace, three XLA gathers or K9's corner
    # fetch, and the stack fused (row: 512x256x256, the bench sphere)
    "advect_fast": ("fluid_simulation_tpu_torch/csrc/advect_fast.cu",
                    "fluid_simulation_tpu/models/windtunnel.py:339-355 with "
                    "fluid_simulation_tpu/kernels/advect_compat.py:150"),
}
# f32 operations per interior cell of each kernel's arithmetic (per sweep
# for the solves), for the operations side of the bound
OPS_PER_CELL = {"rbgs_solve": 8, "rbgs_solve_keep": 9, "pad_bounds": 0,
                "pad_bounds_masked": 2, "confinement": 53,
                # 3 floors, 3 fractions, 7 lerps of 3
                "trilinear_gather": 27,
                # one sweep: the update of each cell and its keep multiply
                "rbgs_sweep_packed": 9, "rbgs_sweep": 9,
                # per sweep of its four solves (three diffusions and the
                # Poisson solve); the projection adds 16 (masked 64) once
                "prestep": 8, "prestep_masked": 9, "rbgs_solve_blocked": 9,
                # per sweep with a keep (8 on an empty scene), as K1 keep
                "rbgs_solve_cpack": 9, "rbgs_solve_cpack_stream": 9,
                "probe_add1": 1,
                # copy2d's add; a sweep of the pass, as K1
                "hbm_stream": 1, "sweepcost_pass": 8,
                # copy2's add; data movement; a pass's coordinate (6) and
                # lerp of 3 fields (9) per output cell; a sweep, as K1
                "dma_stream": 1, "transpose": 0, "strided_copy": 1,
                "lerp_pass": 15, "rbgs_solve_mxu": 8,
                # the coordinate (floor, clip, fraction, 1 - s) once, and a
                # lerp (2 products, a sum) per field, per output
                "lerpcost_pass": 4 + 3 * 3,
                # the masked divergence (6 products, 5 sums, 2 products),
                # |.|, the max and the density add
                "step_stats": 16,
                # 3 backtraces (product, difference, clamp of 2), 3 floors,
                # 3 fractions, 7 lerps of 3, the two mask products
                "advect_compat": 3 * 4 + 3 + 3 + 21 + 2,
                # the backtrace, floors and fractions once, 7 lerps of 3
                # for each of the three saves
                "advect_fast": 3 * 4 + 3 + 3 + 3 * 21}
# the JAX bench's big grids (W, H, D) and its step counts there
# (bench.py:227-263)
BIG = ((256, 128, 128, 10), (256, 256, 256, 4), (512, 256, 256, 3))
# (W, H, D) where the pass kernel's z-march can go wrong (csrc/rbgs_tile.cuh:
# 32 x 16 tiles at nsw 1 and 32 x 32 at nsw 2, 32-plane z-ranges, a ring of
# 2*nsw + 3 planes): D under the ring and the warm-up, D one past a z-range,
# H and W under the tile, a grid of tiles with blocks that splice no face
RAGGED = ((13, 7, 1), (13, 7, 2), (13, 7, 3), (13, 7, 5), (9, 13, 33),
          (80, 70, 6), (37, 21, 65))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.kern = {k: {"max_abs_err": 0.0} for k in KERNELS}
        self.twin_sums = {}   # label -> density sum of an empty run

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:   # record the failed phase, run the others
            self.failures.append(name)
            print(f"FAILED {name}:\n{traceback.format_exc()}", flush=True)
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)

    def check(self, ok, msg):
        if not ok:
            raise AssertionError(msg)

    # -- helpers --------------------------------------------------------

    def rand(self, rng, shape, lo=None, hi=None):
        import numpy as np
        a = (rng.normal(size=shape) if lo is None
             else rng.uniform(lo, hi, size=shape)).astype(np.float32)
        return self.torch.tensor(a, device="cuda")

    def event_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def diff(self, got, want):
        """max |got - want| over tensors or tuples of them; inf when the
        shapes differ or a difference is NaN."""
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        self.torch.cuda.synchronize()
        if len(got) != len(want) or any(a.shape != b.shape
                                        for a, b in zip(got, want)):
            return float("inf")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        return err if err == err else float("inf")

    def compare(self, name, got, want, label, ref="plain"):
        self.record(name, self.diff(got, want), label, ref)

    def compare_bits(self, name, got, want, label):
        """``compare`` to the bits: a zero of the other sign fails too
        (then the error reads inf)."""
        torch = self.torch
        err = self.diff(got, want)
        if err == 0.0 and not all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, want)):
            err = float("inf")
        self.record(name, err, label)

    def pad_ragged(self, rng):
        """K4 and K4 masked against their plain version at ``RAGGED_PAD``,
        1, 2 and 3 fields, both walls, bitwise; the masks are interior
        views of random padded 0/1 masks."""
        from fluid_simulation_tpu_torch.kernels.bounds import (
            pad_bounds, pad_bounds_plain)
        inner = (slice(1, -1),) * 3
        for D, H, W in RAGGED_PAD:
            pads = [(self.rand(rng, (D + 2, H + 2, W + 2), 0.0, 1.0) < 0.7)
                    .float() for _ in range(2)]
            for bs in ((0,), (2, 3), (1, 2, 3)):
                smp = self.rand(rng, (len(bs), D, H, W))
                for wall in ("reference", "noslip"):
                    for name, masks in (
                            ("pad_bounds", ()),
                            ("pad_bounds_masked", [m[inner] for m in pads])):
                        self.compare_bits(
                            name, pad_bounds(smp, bs, wall, *masks),
                            pad_bounds_plain(smp, bs, wall, *masks),
                            f"{W}x{H}x{D} {wall} bs={bs}")

    def record(self, name, err, label, ref="plain"):
        """Keep ``err``, a max |kernel - ref|, as the kernel's and fail
        unless it is 0."""
        ok = err == 0.0
        k = self.kern[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        print(f"   {name:14s} {label:34s} max|kernel-{ref}| = {err:.3g} "
              f"(bound 0: bitwise) {'ok' if ok else 'MISMATCH'}", flush=True)
        self.check(ok, f"{name} {label}: max abs err {err}")

    def bound(self, name, tensors, ops, record=True):
        """The least time the card could take for one call: the bytes of
        its inputs and outputs ``tensors`` (each moved once) at the HBM
        rate, or ``ops`` f32 operations at the f32 rate, the larger. With
        ``record`` it is the kernel's bound in the result line."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
        if record:
            self.kern[name].update(
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)   # no single PyTorch call computes it
        print(f"   {name:14s} bound {max(t_bytes, t_ops) * 1e3:.6f} ms "
              f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mflop)", flush=True)

    def time_pair(self, name, kf, pf, reps, shapes="flagship shapes"):
        ms, pms = self.event_ms(kf, reps), self.event_ms(pf, reps)
        self.kern[name].update(ms=ms, plain_ms=pms)
        print(f"   {name:14s} {shapes}: kernel {ms:.4f} ms"
              f", plain {pms:.4f} ms per call", flush=True)

    def run_path(self, wt, steps, label, once=None, **nonzero):
        """Drive ``wt`` for ``steps`` with the counts set to 0 just before
        and read just after; they must equal ``nonzero`` per step, plus
        ``once`` over the whole run (every other counter 0). Each kernel's
        launches are taken from the first path that runs it."""
        torch = self.torch
        from fluid_simulation_tpu_torch.kernels import LAUNCHES, reset_launches
        reset_launches()
        wt.simulate(steps)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"   launches over {steps} steps: {counts}", flush=True)
        for name, n in counts.items():
            if n and name in self.kern:   # not a form's count inside one
                self.kern[name].setdefault("launches", n)
        want = {k: steps * nonzero.get(k, 0) + (once or {}).get(k, 0)
                for k in counts}
        self.check(counts == want, f"{label}: launch counts {counts} != "
                   f"{want}")

    def step_like(self, rng, pad, keep=None):
        """Three random padded velocities as a run has them: ghost edges
        and corners zero, and with ``keep`` (keep_scalar) zero in solids."""
        torch = self.torch
        shell = torch.zeros(pad, device="cuda")
        shell[1:-1, 1:-1, :] = shell[1:-1, :, 1:-1] = 1.0
        shell[:, 1:-1, 1:-1] = 1.0
        if keep is not None:
            shell = shell * keep
        return [self.rand(rng, pad) * shell for _ in range(3)]

    def kernel_vs_plain_steps(self, wt, steps):
        """``steps`` more steps on the kernel path and on the plain path
        from the same state; they must agree bit for bit."""
        from fluid_simulation_tpu_torch.models.windtunnel import (
            simulation_step)
        kern = plain = wt.state
        plain_p = wt.params.replace(use_pallas=False)
        for _ in range(steps):
            kern, _ = simulation_step(kern, wt.masks, wt.params)
            plain, _ = simulation_step(plain, wt.masks, plain_p)
        err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
        print(f"   {steps} steps kernel path vs plain path: max abs diff "
              f"{err:.3g} (bound 0: every kernel is bitwise to its plain "
              f"version)", flush=True)
        self.check(err == 0.0, f"kernel vs plain path differ by {err}")

    # -- phases -----------------------------------------------------------

    def kernels(self):
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.advect_split import (
            advect_split, advect_split_plain)
        from fluid_simulation_tpu_torch.kernels.bounds import (
            pad_bounds, pad_bounds_plain)
        from fluid_simulation_tpu_torch.kernels.linsolve import (
            rbgs_solve, rbgs_solve_plain)
        from fluid_simulation_tpu_torch.kernels.project import (
            project_empty, project_empty_plain)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs

        rng = np.random.default_rng(SEED)
        for (W, H, D), wall, flagship in (((128, 64, 64), "reference", True),
                                          ((13, 7, 5), "noslip", False)):
            pad = (D + 2, H + 2, W + 2)
            tag = f"{W}x{H}x{D} {wall}"
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            b = 1 if flagship else 2
            k1 = lambda: rbgs_solve(b, f, g, a, c, 15, wall)      # noqa: E731
            p1 = lambda: rbgs_solve_plain(b, f, g, a, c, 15, wall)  # noqa: E731
            self.compare("rbgs_solve", k1(), p1(), f"{tag} b={b}")

            vel = [self.rand(rng, pad) for _ in range(3)]
            k2 = lambda: project_empty(*vel, 15, wall)             # noqa: E731
            p2 = lambda: project_empty_plain(*vel, 15, wall)       # noqa: E731
            self.compare("project_empty", k2(), p2(), tag)

            vx = self.rand(rng, pad, -20.0, 40.0)
            vy, vz = (self.rand(rng, pad, -3.0, 3.0) for _ in range(2))
            stack = self.torch.stack([self.rand(rng, pad) for _ in range(3)])
            dens = self.rand(rng, pad).abs()
            k3 = lambda: advect_split(stack, vx, vy, vz, 0.05)      # noqa: E731
            p3 = lambda: advect_split_plain(stack, vx, vy, vz, 0.05)  # noqa: E731
            self.compare("advect_split", k3(), p3(), f"{tag} stack of 3")
            self.compare("advect_split", advect_split(dens, vx, vy, vz, 0.05),
                         advect_split_plain(dens, vx, vy, vz, 0.05),
                         f"{tag} single field")

            smp3 = self.rand(rng, (3, D, H, W))
            smp1 = self.rand(rng, (1, D, H, W))
            k4 = lambda: pad_bounds(smp3, (1, 2, 3), wall)          # noqa: E731
            p4 = lambda: pad_bounds_plain(smp3, (1, 2, 3), wall)    # noqa: E731
            self.compare_bits("pad_bounds", k4(), p4(), f"{tag} bs=(1,2,3)")
            self.compare_bits("pad_bounds", pad_bounds(smp1, (0,), wall),
                              pad_bounds_plain(smp1, (0,), wall),
                              f"{tag} bs=(0,)")

            if flagship:
                for name, kf, pf, reps in (("rbgs_solve", k1, p1, 20),
                                           ("project_empty", k2, p2, 20),
                                           ("advect_split", k3, p3, 50),
                                           ("pad_bounds", k4, p4, 50)):
                    self.time_pair(name, kf, pf, reps)
                n, D2, H2 = W * H * D, D + 2, H + 2
                # the solve reads prev (g) at interior cells only
                self.bound("rbgs_solve", (f, g[1:-1, 1:-1, 1:-1], f),
                           15 * OPS_PER_CELL["rbgs_solve"] * n)
                # divergence 7, sweeps 8 each, gradient and update 9
                self.bound("project_empty", (*vel, *vel), (16 + 8 * 15) * n)
                # per pass and output cell: coordinate 6, lerp 3 per field
                lerp_ops = (6 + 3 * 3) * (D2 * H2 * W + D2 * H * W + n)
                out3 = k3()
                self.bound("advect_split", (stack, vx, vy, vz, out3),
                           lerp_ops)
                self.bound("pad_bounds", (smp3, *k4()), 0)
        self.pad_ragged(rng)

    def split_flagship(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        wt = WindTunnel(SimParams(mode="split", div_stats=False,
                                  step_stats=False), device="cuda")
        self.run_path(wt, 100, "split 3/2/2/2 per step", rbgs_solve=3,
                      project_empty=2, advect_split=2, pad_bounds=2)
        self.check_state(wt, "split 128x64x64")
        self.twin_sums["split 128x64x64"] = wt.density_sum()
        self.kernel_vs_plain_steps(wt, 3)

    def check_state(self, wt, label):
        torch = self.torch
        s = wt.state
        finite = all(bool(torch.isfinite(f).all()) for f in s)
        dsum = wt.density_sum()
        vx, vy, vz = (f.float() for f in (s.vx, s.vy, s.vz))
        div = 0.5 * (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2]
                     + vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1]
                     + vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1]).abs()
        dmax, dmean = float(div.max()), float(div.mean())
        print(f"   {label}: finite={finite} density_sum={dsum:.6g} "
              f"div residual max={dmax:.4g} mean={dmean:.4g}", flush=True)
        self.check(finite and dsum > 0, f"{label}: non-finite or empty state")
        self.check(dmax < RESIDUAL_MAX and dmean < RESIDUAL_MEAN,
                   f"{label}: residual max {dmax} mean {dmean}")

    def compat_parity(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        wt = WindTunnel(SimParams(div_stats=False, step_stats=False),
                        device="cuda")
        self.run_path(wt, 100, "compat 3/2/4 per step", rbgs_solve=3,
                      project_empty=2, advect_compat=4)
        self.check_parity(wt)

    def check_parity(self, wt):
        """The reference's own print after 100 compat steps at 128x64x64."""
        dsum = wt.density_sum()
        dmax = wt.field_ranges()["density"][1]
        print(f"   density_sum={dsum:.6g} (ref {REF_SUM}, "
              f"{100 * (dsum - REF_SUM) / REF_SUM:+.3f} %), dens_max="
              f"{dmax:.6g} (ref {REF_MAX}, "
              f"{100 * (dmax - REF_MAX) / REF_MAX:+.3f} %)", flush=True)
        self.check(abs(dsum - REF_SUM) / REF_SUM <= SUM_BAND,
                   f"density sum {dsum} outside 1.5 % of {REF_SUM}")
        self.check(abs(dmax - REF_MAX) / REF_MAX <= MAX_BAND,
                   f"dens max {dmax} outside 2 % of {REF_MAX}")

    def obstacle_kernels(self):
        """K1 keep, K6, K4 masked and K10 against their plain versions: the
        bench sphere's masks at 128x64x64, a random 0/1 obstacle field with
        no-slip walls at 13x7x5."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.bounds import (
            pad_bounds, pad_bounds_plain)
        from fluid_simulation_tpu_torch.kernels.linsolve import (
            rbgs_solve, rbgs_solve_plain)
        from fluid_simulation_tpu_torch.kernels.project import (
            project_masked, project_masked_plain)
        from fluid_simulation_tpu_torch.kernels.vorticity import (
            confinement, confinement_plain)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere

        rng = np.random.default_rng(SEED + 1)
        small = np.zeros((7, 9, 15), np.float32)
        small[1:-1, 1:-1, 1:-1] = rng.uniform(size=(5, 7, 13)) < 0.2
        for obs, wall, flagship in ((flagship_sphere(), "reference", True),
                                    (small, "noslip", False)):
            D2, H2, W2 = pad = obs.shape
            D, H, W = D2 - 2, H2 - 2, W2 - 2
            n = D * H * W
            m = build_masks(obs, device="cuda")
            tag = f"{W}x{H}x{D} {wall}"
            kv = m.keep_vel[1:-1, 1:-1, 1:-1]
            print(f"   {tag}: {int(m.solid.sum())} solid cells", flush=True)
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            for b, keep in ((0, m.keep_scalar), (1, m.keep_vel)):
                k1 = lambda: rbgs_solve(b, f, g, a, c, 15, wall,  # noqa: E731
                                        keep)
                p1 = lambda: rbgs_solve_plain(b, f, g, a, c,  # noqa: E731
                                              15, wall, keep)
                self.compare("rbgs_solve_keep", k1(), p1(), f"{tag} b={b}")

            vel = [self.rand(rng, pad) for _ in range(3)]
            k6 = lambda: project_masked(*vel, m.fluid_i, kv,  # noqa: E731
                                        15, wall)
            p6 = lambda: project_masked_plain(*vel, m.fluid_i,  # noqa: E731
                                              kv, 15, wall)
            self.compare("project_masked", k6(), p6(), tag)

            smp3 = self.rand(rng, (3, D, H, W))
            smp1 = self.rand(rng, (1, D, H, W))
            k4 = lambda: pad_bounds(smp3, (1, 2, 3), wall,  # noqa: E731
                                    m.fluid_i, kv)
            p4 = lambda: pad_bounds_plain(smp3, (1, 2, 3), wall,  # noqa: E731
                                          m.fluid_i, kv)
            self.compare_bits("pad_bounds_masked", k4(), p4(),
                              f"{tag} bs=(1,2,3)")
            ks = m.keep_scalar[1:-1, 1:-1, 1:-1]
            self.compare_bits("pad_bounds_masked",
                              pad_bounds(smp1, (0,), wall, m.fluid_i, ks),
                              pad_bounds_plain(smp1, (0,), wall, m.fluid_i,
                                               ks), f"{tag} bs=(0,)")

            wv = [self.rand(rng, pad, -3.0, 3.0) for _ in range(3)]
            k10 = lambda: confinement(*wv, kv, 5.0, 0.05)  # noqa: E731
            p10 = lambda: confinement_plain(*wv, kv, 5.0, 0.05)  # noqa: E731
            self.compare("confinement", k10(), p10(),
                         f"{tag} eps=5 dt=0.05")

            if flagship:
                for name, kf, pf, reps in (
                        ("rbgs_solve_keep", k1, p1, 20),
                        ("project_masked", k6, p6, 20),
                        ("pad_bounds_masked", k4, p4, 50),
                        ("confinement", k10, p10, 50)):
                    self.time_pair(name, kf, pf, reps)
                self.bound("rbgs_solve_keep", (f, g[1:-1, 1:-1, 1:-1], kv, f),
                           15 * OPS_PER_CELL["rbgs_solve_keep"] * n)
                # divergence 13, keep sweeps 9 each, gradient and update 51
                self.bound("project_masked", (*vel, m.fluid_i, kv, *vel),
                           (64 + 9 * 15) * n)
                self.bound("pad_bounds_masked",
                           (smp3, m.fluid_i, kv, *k4()),
                           3 * OPS_PER_CELL["pad_bounds_masked"] * n)
                self.bound("confinement", (*wv, kv, *wv),
                           OPS_PER_CELL["confinement"] * n)

    def check_scene(self, wt, label, twin=None):
        """An obstacle run: the residual bounds, every field exactly 0 in
        every solid cell, and with ``twin`` (the label of an empty run of
        as many steps) a density sum that differs from that run's
        (bench.py's obstacle-blind guard)."""
        torch = self.torch
        self.check_state(wt, label)
        solid = wt.masks.solid >= 0.5
        nonzero = sum(int(torch.count_nonzero(f[solid])) for f in wt.state)
        print(f"   {label}: {int(solid.sum())} solid cells, {nonzero} "
              f"nonzero field values in them", flush=True)
        self.check(nonzero == 0, f"{label}: solid cells are not 0")
        if twin:
            empty = self.twin_sums.get(twin)
            self.check(empty is not None, f"{label}: no density sum from the "
                       f"empty run {twin!r} to hold it against")
            dsum = wt.density_sum()
            print(f"   {label}: density sum {dsum:.6g} vs empty tunnel "
                  f"{empty:.6g}", flush=True)
            self.check(dsum != empty, f"{label}: density sum equals the "
                       f"empty tunnel's (obstacle-blind)")

    def sphere_split(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere
        wt = WindTunnel(SimParams(mode="split", div_stats=False,
                                  step_stats=False),
                        obstacles=flagship_sphere(), device="cuda")
        self.run_path(wt, 100, "sphere split", rbgs_solve_keep=3,
                      project_masked=2, advect_split=2, pad_bounds_masked=2)
        self.check_scene(wt, "sphere split 128x64x64",
                         twin="split 128x64x64")
        self.kernel_vs_plain_steps(wt, 3)

    def sphere_compat(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere
        wt = WindTunnel(SimParams(div_stats=False, step_stats=False),
                        obstacles=flagship_sphere(), device="cuda")
        self.run_path(wt, 20, "sphere compat", rbgs_solve_keep=3,
                      project_masked=2, advect_compat=4)
        self.check_scene(wt, "sphere compat 128x64x64")
        self.kernel_vs_plain_steps(wt, 2)

    def stl_split(self):
        import numpy as np
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.config import SceneParams
        from fluid_simulation_tpu_torch.scene import (
            empty_obstacles, load_stl_into_obstacles)
        here = os.path.dirname(os.path.abspath(__file__))
        scene = SceneParams(**{**STL_SCENE, "stl_path": os.path.join(
            here, STL_SCENE["stl_path"])})
        obs = load_stl_into_obstacles(scene, empty_obstacles(128, 64, 64))
        n_solid = int((np.asarray(obs) >= 0.5).sum())
        print(f"   STL scene {STL_SCENE}: {n_solid} solid cells", flush=True)
        self.check(n_solid > 0, "the STL scene voxelized to no solid cell")
        wt = WindTunnel(SimParams(mode="split", div_stats=False,
                                  step_stats=False), obstacles=obs,
                        device="cuda")
        self.run_path(wt, 100, "STL split", rbgs_solve_keep=3,
                      project_masked=2, advect_split=2, pad_bounds_masked=2)
        self.check_scene(wt, "STL split 128x64x64", twin="split 128x64x64")
        self.kernel_vs_plain_steps(wt, 3)

    def noslip_vorticity(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        wt = WindTunnel(SimParams(mode="split", wall_mode="noslip",
                                  vorticity=5.0, div_stats=False,
                                  step_stats=False), device="cuda")
        self.run_path(wt, 100, "noslip+vorticity split", rbgs_solve=3,
                      project_empty=2, advect_split=2, pad_bounds=2,
                      confinement=1)
        self.check_state(wt, "noslip+vorticity split 128x64x64")
        self.kernel_vs_plain_steps(wt, 3)

    def stream_kernels(self):
        """The big-grid route's four kernels against their plain versions,
        its two wrappers against theirs and against the resident route: the
        bench sphere's masks at 256x128x128, random 0/1 solids with no-slip
        walls at 13x7x10 (every tile axis ragged)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            linsolve_stream as ls, project_stream as ps)
        from fluid_simulation_tpu_torch.kernels.bounds import pad_bounds
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        from fluid_simulation_tpu_torch.kernels.project import (
            divergence_plain, project_empty, project_masked)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import big_sphere

        rng = np.random.default_rng(SEED + 2)
        small = np.zeros((12, 9, 15), np.float32)
        small[1:-1, 1:-1, 1:-1] = rng.uniform(size=(10, 7, 13)) < 0.2
        for obs, wall, main in ((big_sphere(256, 128, 128), "reference",
                                 True), (small, "noslip", False)):
            D2, H2, W2 = pad = obs.shape
            D, H, W = D2 - 2, H2 - 2, W2 - 2
            n = D * H * W
            m = build_masks(obs, device="cuda")
            tag = f"{W}x{H}x{D} {wall}"
            kv = m.keep_vel[1:-1, 1:-1, 1:-1]
            print(f"   {tag}: {int(m.solid.sum())} solid cells", flush=True)
            self.check_tables(m, tag)
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            b = 1 if main else 2
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            rhs_i = g[1:-1, 1:-1, 1:-1]
            fpre = self.rand(rng, (D, H, W))
            # each kernel alone
            self.compare("rbgs_solve_stream", ls.sweep1(f, rhs_i, a, c),
                         ls.sweep1_plain(f, rhs_i, a, c), f"{tag} rbgs_sweep1")
            for nsw in ls.KERNEL_NSW:
                for name, keep_i in (("rbgs_solve_stream", None),
                                     ("rbgs_solve_stream_keep", kv)):
                    self.compare(
                        name, ls.sweep_pass(fpre, rhs_i, keep_i, b, a, c, nsw,
                                            wall),
                        ls.pass_plain(fpre, rhs_i, keep_i, b, a, c, nsw,
                                      wall), f"{tag} rbgs_pass nsw={nsw}")
            vel = [self.rand(rng, pad) for _ in range(3)]
            for name, fl in (("project_stream", None),
                             ("project_stream_masked", m.fluid_i)):
                self.compare(name, ps.divergence_packed(*vel, fl),
                             divergence_plain(*vel, fl), f"{tag} div_packed")
                self.compare(name, ps.gradient_packed(*vel, fpre, fl),
                             ps.gradient_packed_plain(*vel, fpre, fl),
                             f"{tag} grad_packed")
            # the wrappers: passes of 2 and of 1, an odd acc, remainders
            for nsw, acc in ((2, 15), (2, 6), (1, 5)):
                self.compare("rbgs_solve_stream",
                             ls.rbgs_solve_stream(b, f, g, a, c, acc, wall,
                                                  nsw=nsw),
                             ls.rbgs_solve_stream_plain(b, f, g, a, c, acc,
                                                        wall, nsw=nsw),
                             f"{tag} b={b} acc={acc} nsw={nsw}")
                self.compare("rbgs_solve_stream_keep",
                             ls.rbgs_solve_stream(b, f, g, a, c, acc, wall,
                                                  m.keep_vel, nsw),
                             ls.rbgs_solve_stream_plain(b, f, g, a, c, acc,
                                                        wall, m.keep_vel,
                                                        nsw),
                             f"{tag} b={b} acc={acc} nsw={nsw}")
            for nsw in ls.KERNEL_NSW:
                self.compare("project_stream",
                             ps.project_stream(*vel, 15, wall, nsw),
                             ps.project_stream_plain(*vel, 15, wall, nsw),
                             f"{tag} nsw={nsw}")
                self.compare("project_stream_masked",
                             ps.project_stream_masked(*vel, m.fluid_i, 15,
                                                      wall, nsw),
                             ps.project_stream_masked_plain(
                                 *vel, m.fluid_i, 15, wall, nsw),
                             f"{tag} nsw={nsw}")
            # against the resident route, on step-like velocities
            for bb in range(4):
                keep = m.keep_vel if bb else m.keep_scalar
                self.compare("rbgs_solve_stream",
                             ls.rbgs_solve_stream(bb, f, g, a, c, 15, wall),
                             rbgs_solve(bb, f, g, a, c, 15, wall),
                             f"{tag} b={bb}", ref="resident")
                self.compare("rbgs_solve_stream_keep",
                             ls.rbgs_solve_stream(bb, f, g, a, c, 15, wall,
                                                  keep),
                             rbgs_solve(bb, f, g, a, c, 15, wall, keep),
                             f"{tag} b={bb}", ref="resident")
            sv = self.step_like(rng, pad)
            self.compare("project_stream",
                         pad_bounds(ps.project_stream(*sv, 15, wall),
                                    (1, 2, 3), wall),
                         project_empty(*sv, 15, wall), f"{tag} + tail",
                         ref="resident")
            sv = self.step_like(rng, pad, m.keep_scalar)
            self.compare("project_stream_masked",
                         pad_bounds(ps.project_stream_masked(
                             *sv, m.fluid_i, 15, wall), (1, 2, 3), wall,
                             m.fluid_i, kv),
                         project_masked(*sv, m.fluid_i, kv, 15, wall),
                         f"{tag} + tail", ref="resident")

            if main:
                shapes = f"{W}x{H}x{D} shapes"
                for name, kf, pf in (
                        ("rbgs_solve_stream",
                         lambda: ls.rbgs_solve_stream(b, f, g, a, c, 15),
                         lambda: ls.rbgs_solve_stream_plain(b, f, g, a, c,
                                                            15)),
                        ("rbgs_solve_stream_keep",
                         lambda: ls.rbgs_solve_stream(b, f, g, a, c, 15,
                                                      keep=m.keep_vel),
                         lambda: ls.rbgs_solve_stream_plain(
                             b, f, g, a, c, 15, keep=m.keep_vel)),
                        ("project_stream",
                         lambda: ps.project_stream(*vel, 15),
                         lambda: ps.project_stream_plain(*vel, 15)),
                        ("project_stream_masked",
                         lambda: ps.project_stream_masked(*vel, m.fluid_i,
                                                          15),
                         lambda: ps.project_stream_masked_plain(
                             *vel, m.fluid_i, 15))):
                    self.time_pair(name, kf, pf, 10, shapes)
                self.stream_bounds(f, g, kv, vel, m.fluid_i, n, True)
        self.stream_ragged(rng)

    def check_tables(self, m, label):
        """The keep passes' tables of the masks ``m`` (the ``keep_vel``
        interior view and ``fluid_i``, nsw 1 and 2; those a run built are
        read from the cache, the others built here by ``fst_march_table``):
        byte for byte ``march_table_plain``'s of a host copy, and the same
        count of flagged blocks."""
        from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls
        torch = self.torch
        for name, keep_i in (("keep_vel", m.keep_vel[1:-1, 1:-1, 1:-1]),
                             ("fluid_i", m.fluid_i)):
            for nsw in ls.KERNEL_NSW:
                table, flagged = ls.march_table(keep_i, nsw)
                plain = ls.march_table_plain(keep_i.cpu(), nsw)
                got, want = int(flagged), int(plain.sum())
                print(f"   {label} {name} nsw={nsw}: table flags {got} of "
                      f"{table.numel()} blocks (plain {want})", flush=True)
                self.check(torch.equal(table.cpu(), plain) and got == want,
                           f"{label} {name} nsw={nsw}: march_table != "
                           f"march_table_plain")

    def stream_ragged(self, rng):
        """Sweep 1 and the pass at nsw 1 and 2, keep (random 0/1 solids)
        and empty, b = 0..3 and both walls, at each ``RAGGED`` shape:
        bitwise to their plain versions."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        for W, H, D in RAGGED:
            obs = np.zeros((D + 2, H + 2, W + 2), np.float32)
            obs[1:-1, 1:-1, 1:-1] = rng.uniform(size=(D, H, W)) < 0.2
            m = build_masks(obs, device="cuda")
            err = {"rbgs_solve_stream": 0.0, "rbgs_solve_stream_keep": 0.0}
            forms = 0
            for b in range(4):
                for wall in ("reference", "noslip"):
                    kv = (m.keep_vel if b else m.keep_scalar)[1:-1, 1:-1,
                                                              1:-1]
                    g = self.rand(rng, (D + 2, H + 2, W + 2))
                    rhs_i = g[1:-1, 1:-1, 1:-1]
                    fpre = self.rand(rng, (D, H, W))
                    pairs = [("rbgs_solve_stream", ls.sweep1(g, rhs_i, 0.7,
                                                            5.2),
                              ls.sweep1_plain(g, rhs_i, 0.7, 5.2))]
                    for nsw in ls.KERNEL_NSW:
                        for name, keep_i in (("rbgs_solve_stream", None),
                                             ("rbgs_solve_stream_keep", kv)):
                            pairs.append((name, ls.sweep_pass(
                                fpre, rhs_i, keep_i, b, 0.7, 5.2, nsw, wall),
                                ls.pass_plain(fpre, rhs_i, keep_i, b, 0.7,
                                              5.2, nsw, wall)))
                    for name, got, want in pairs:
                        err[name] = max(err[name], self.diff(got, want))
                    forms += len(pairs)
            for name, e in err.items():
                self.record(name, e, f"{W}x{H}x{D} z-march ({forms} forms)")

    def stream_bounds(self, f, g, kv, vel, fluid_i, n, record):
        """The streamed wrappers' bounds at one shape: the solves read the
        field, prev's interior (and keep) and write the field; the
        projections read the three velocities (and fluid_i) and write three
        interiors."""
        torch = self.torch
        out3 = torch.empty((3,) + tuple(kv.shape), device="cuda")
        self.bound("rbgs_solve_stream", (f, g[1:-1, 1:-1, 1:-1], f),
                   15 * OPS_PER_CELL["rbgs_solve"] * n, record)
        self.bound("rbgs_solve_stream_keep",
                   (f, g[1:-1, 1:-1, 1:-1], kv, f),
                   15 * OPS_PER_CELL["rbgs_solve_keep"] * n, record)
        # as K2 and K6: divergence, 15 sweeps, gradient and update
        self.bound("project_stream", (*vel, out3), (16 + 8 * 15) * n, record)
        self.bound("project_stream_masked", (*vel, fluid_i, out3),
                   (64 + 9 * 15) * n, record)

    def big_grids(self):
        """The bench's six big configs through the entry point."""
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.scene.primitives import big_sphere
        for W, H, D, steps in BIG:
            p = SimParams(width=W, height=H, depth=D, mode="split",
                          div_stats=False, step_stats=False)
            for sphere in (False, True):
                label = f"split {W}x{H}x{D}" + (" sphere" if sphere else "")
                wt = WindTunnel(p, obstacles=big_sphere(W, H, D) if sphere
                                else None, device="cuda")
                if sphere:
                    # the keep passes: 3 solves of 7 (after sweep 1), 2
                    # projections of 7 and a one-sweep remainder; their
                    # tables (keep_vel at nsw 2, fluid_i at nsw 2 and 1)
                    # built once, in the first step
                    self.run_path(wt, steps, label, rbgs_solve_stream_keep=3,
                                  project_stream_masked=2, advect_split=2,
                                  pad_bounds_masked=4, rbgs_pass_keep=37,
                                  once={"march_table": 3})
                    self.check_tables(wt.masks, label)
                    self.check_scene(wt, label, twin=f"split {W}x{H}x{D}")
                else:
                    self.run_path(wt, steps, label, rbgs_solve_stream=3,
                                  project_stream=2, advect_split=2,
                                  pad_bounds=4)
                    self.check_state(wt, label)
                    self.twin_sums[label] = wt.density_sum()
                print(f"   {label}: density sum after {steps} steps "
                      f"{wt.density_sum()!r} (exact)", flush=True)
                if (W, H, D) == (256, 128, 128):
                    self.kernel_vs_plain_steps(wt, 1)
                ms = self.event_ms(wt.step, steps)
                print(f"   {label}: kernel path {ms:.4f} ms/step "
                      f"({p.n_cells / ms * 1e3:.4g} cell-updates/s)",
                      flush=True)
                del wt
                self.torch.cuda.empty_cache()

    def route_times(self):
        """Per call at each big shape, the resident and the streamed route of
        the solve and of the projection (with its pad_bounds tail), in turns
        (resident, streamed, streamed, resident); the streamed wrappers'
        bounds there; K4 and K4 masked against their plain versions at
        512x256x256."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            linsolve_stream as ls, project_stream as ps)
        from fluid_simulation_tpu_torch.kernels.bounds import (
            pad_bounds, pad_bounds_plain)
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        from fluid_simulation_tpu_torch.kernels.project import (
            project_empty, project_masked)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import big_sphere

        torch = self.torch
        rng = np.random.default_rng(SEED + 3)
        for W, H, D, _ in BIG:
            pad = (D + 2, H + 2, W + 2)
            m = build_masks(big_sphere(W, H, D), device="cuda")
            kv = m.keep_vel[1:-1, 1:-1, 1:-1]
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            vel = self.step_like(rng, pad, m.keep_scalar)
            reps = 5 if W * H * D > (1 << 23) else 10
            for label, res, st in (
                    ("solve", lambda: rbgs_solve(1, f, g, a, c, 15),
                     lambda: ls.rbgs_solve_stream(1, f, g, a, c, 15)),
                    ("solve keep",
                     lambda: rbgs_solve(1, f, g, a, c, 15, keep=m.keep_vel),
                     lambda: ls.rbgs_solve_stream(1, f, g, a, c, 15,
                                                  keep=m.keep_vel)),
                    ("projection", lambda: project_empty(*vel, 15),
                     lambda: pad_bounds(ps.project_stream(*vel, 15),
                                        (1, 2, 3))),
                    ("projection masked",
                     lambda: project_masked(*vel, m.fluid_i, kv, 15),
                     lambda: pad_bounds(ps.project_stream_masked(
                         *vel, m.fluid_i, 15), (1, 2, 3), "reference",
                         m.fluid_i, kv))):
                r1, s1, s2, r2 = (self.event_ms(fn, reps)
                                  for fn in (res, st, st, res))
                print(f"   {W}x{H}x{D} {label:17s}: resident "
                      f"{(r1 + r2) / 2:.4f} ms ({r1:.4f}, {r2:.4f}), "
                      f"streamed {(s1 + s2) / 2:.4f} ms ({s1:.4f}, {s2:.4f})"
                      f" per call", flush=True)
            self.stream_bounds(f, g, kv, vel, m.fluid_i, W * H * D, False)
            del f, g, vel
        # K4 and K4 masked at the 512x256x256 shapes (m from the last grid)
        smp3 = self.rand(rng, (3, D, H, W))
        self.compare_bits("pad_bounds", pad_bounds(smp3, (1, 2, 3)),
                          pad_bounds_plain(smp3, (1, 2, 3)),
                          f"{W}x{H}x{D} bs=(1,2,3)")
        self.compare_bits("pad_bounds_masked",
                          pad_bounds(smp3, (1, 2, 3), "reference", m.fluid_i,
                                     kv),
                          pad_bounds_plain(smp3, (1, 2, 3), "reference",
                                           m.fluid_i, kv),
                          f"{W}x{H}x{D} bs=(1,2,3)")
        for name, masks in (("pad_bounds", ()),
                            ("pad_bounds_masked", (m.fluid_i, kv))):
            kf = lambda: pad_bounds(smp3, (1, 2, 3), "reference",  # noqa
                                    *masks)
            pf = lambda: pad_bounds_plain(smp3, (1, 2, 3),  # noqa: E731
                                          "reference", *masks)
            ms, pms = self.event_ms(kf, 10), self.event_ms(pf, 5)
            # the interiors and masks read once, the padded fields written
            nbytes = sum(t.numel() * 4 for t in (smp3, *masks, *kf()))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"   {name:14s} {W}x{H}x{D} shapes: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms per call (3 fields); bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB), "
                  f"{100 * bound_ms / ms:.1f} % of it", flush=True)
        torch.cuda.empty_cache()

    def same_state(self, a, b, label):
        """Two runs' states must agree bit for bit."""
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        print(f"   {label}: max abs diff {err:.3g} (bound 0: bitwise)",
              flush=True)
        self.check(err == 0.0, f"{label}: states differ by {err}")

    def ms_ab(self, label, arms, reps):
        """ms/step of two runs in turns (first, second, second, first); each
        arm is ``(name, one-step function)``."""
        (na, fa), (nb, fb) = arms
        ta1, tb1, tb2, ta2 = (self.event_ms(f, reps) for f in (fa, fb, fb, fa))
        print(f"   {label}: {na} {(ta1 + ta2) / 2:.4f} ms/step ({ta1:.4f}, "
              f"{ta2:.4f}), {nb} {(tb1 + tb2) / 2:.4f} ms/step ({tb1:.4f}, "
              f"{tb2:.4f})", flush=True)

    def variant_kernels(self):
        """K9, K5, K1 unpacked and K8 against their plain versions at the
        128x64x64 shapes; K9 also beside grid_sample."""
        import numpy as np
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.kernels.advect_compat import (
            trilinear_gather_window)
        from fluid_simulation_tpu_torch.kernels.advect_split import (
            advect_split_fused, advect_split_plain)
        from fluid_simulation_tpu_torch.kernels.linsolve import (
            rbgs_solve, rbgs_solve3, rbgs_solve3_plain, rbgs_solve_plain)
        from fluid_simulation_tpu_torch.ops.advect import (
            backtrace, trilinear_gather)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.tools.exp_transpose import (
            measure_body)
        from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere

        torch = self.torch
        rng = np.random.default_rng(SEED + 4)
        W, H, D = 128, 64, 64
        pad, n = (D + 2, H + 2, W + 2), W * H * D
        interior = (D, H, W)

        # K9 on random backtraces, y/z offsets up to 16 cells
        prev = self.rand(rng, pad)
        vel = [self.rand(rng, interior, lo, hi)
               for lo, hi in ((-20.0, 40.0), (-5.0, 5.0), (-5.0, 5.0))]
        xb, yb, zb = backtrace(*vel, 0.05, W, H, D, torch.float32)
        yi = torch.arange(1, H + 1, device="cuda").view(1, H, 1)
        zi = torch.arange(1, D + 1, device="cuda").view(D, 1, 1)
        reach = int(max((torch.floor(yb) - yi).abs().max(),
                        (torch.floor(zb) - zi).abs().max()))
        self.check(reach >= 10, f"backtraces reach only {reach} cells")
        k9 = lambda: trilinear_gather_window(prev, xb, yb, zb)  # noqa: E731
        p9 = lambda: trilinear_gather(prev, xb, yb, zb)         # noqa: E731
        self.compare("trilinear_gather", k9(), p9(),
                     f"128x64x64 reach {reach} cells")
        # K9 on a sphere state after 20 compat steps
        wt = WindTunnel(SimParams(div_stats=False, step_stats=False),
                        obstacles=flagship_sphere(), device="cuda")
        wt.simulate(20)
        st = wt.state
        sb = backtrace(*(f[1:-1, 1:-1, 1:-1] for f in st[:3]), wt.params.dt,
                       W, H, D, torch.float32)
        for name, f in zip(("vx", "vy", "vz", "dens"), st):
            self.compare("trilinear_gather", trilinear_gather_window(f, *sb),
                         trilinear_gather(f, *sb),
                         f"sphere compat step 20 {name}")
        # the one PyTorch call that samples trilinearly: grid_sample with
        # the coordinates mapped to [-1, 1] (align_corners: -1 is index 0)
        grid = torch.stack([c * (2.0 / (m + 1)) - 1.0 for c, m in
                            ((xb, W), (yb, H), (zb, D))], dim=-1)[None]
        inp = prev[None, None]
        lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            inp, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        lib_err = float((lib()[0, 0] - k9()).abs().max())
        self.time_pair("trilinear_gather", k9, p9, 50)
        lib_ms = self.event_ms(lib, 50)
        print(f"   grid_sample    128x64x64: {lib_ms:.4f} ms per call, "
              f"max|grid_sample-kernel| = {lib_err:.3g} (another "
              f"arithmetic: not a port, never on a path)", flush=True)
        # device time: CUDA-graph replays, no host launch in the clock
        k9_dev, lib_dev = (measure_body(f, 10, "cuda") * 1e3
                           for f in (k9, lib))
        print(f"   trilinear_gather random backtraces, device (graph "
              f"replay): kernel {k9_dev:.4f} ms, grid_sample "
              f"{lib_dev:.4f} ms per call", flush=True)
        self.bound("trilinear_gather", (prev, xb, yb, zb, k9()),
                   OPS_PER_CELL["trilinear_gather"] * n)
        self.kern["trilinear_gather"]["library_ms"] = lib_ms
        self.kern["trilinear_gather"]["launches"] = 0   # no route

        # K5 empty, with keep, with keep and no-slip walls; also against
        # three K1 calls
        a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
        fs = [self.rand(rng, pad) for _ in range(3)]
        ps = [self.rand(rng, pad) for _ in range(3)]
        m = build_masks(flagship_sphere(), device="cuda")
        for label, keep, wall in (("empty", None, "reference"),
                                  ("keep", m.keep_vel, "reference"),
                                  ("keep noslip", m.keep_vel, "noslip")):
            got = rbgs_solve3((1, 2, 3), *fs, *ps, a, c, 15, wall, keep)
            self.compare("rbgs_solve3", got, rbgs_solve3_plain(
                (1, 2, 3), *fs, *ps, a, c, 15, wall, keep),
                f"128x64x64 {label}")
            self.compare("rbgs_solve3", got, tuple(
                rbgs_solve(b, f, p, a, c, 15, wall, keep)
                for b, f, p in zip((1, 2, 3), fs, ps)), f"128x64x64 {label}",
                ref="3 K1")
        for label, keep in (("keep", m.keep_vel), ("empty", None)):
            k5 = lambda: rbgs_solve3((1, 2, 3), *fs, *ps,  # noqa: E731
                                     a, c, 15, keep=keep)
            p5 = lambda: rbgs_solve3_plain((1, 2, 3), *fs,  # noqa: E731
                                           *ps, a, c, 15, keep=keep)
            k1x3 = lambda: [rbgs_solve(b, f, p, a, c, 15,  # noqa: E731
                                       keep=keep)
                            for b, f, p in zip((1, 2, 3), fs, ps)]
            # the empty form's times go to the result line
            if keep is None:
                self.time_pair("rbgs_solve3", k5, p5, 20)
            else:
                print(f"   rbgs_solve3    keep: kernel "
                      f"{self.event_ms(k5, 20):.4f} ms, plain "
                      f"{self.event_ms(p5, 5):.4f} ms per call", flush=True)
            print(f"   rbgs_solve3    {label}: three K1 calls "
                  f"{self.event_ms(k1x3, 20):.4f} ms", flush=True)
        ps_i = [p[1:-1, 1:-1, 1:-1] for p in ps]
        self.bound("rbgs_solve3", (*fs, *ps_i, *fs),
                   3 * 15 * OPS_PER_CELL["rbgs_solve"] * n)
        self.bound("rbgs_solve3", (*fs, *ps_i, m.keep_vel[1:-1, 1:-1, 1:-1],
                                   *fs),
                   3 * 15 * OPS_PER_CELL["rbgs_solve_keep"] * n, False)
        self.kern["rbgs_solve3"]["launches"] = 0   # no route

        # K1 unpacked: a random 0/1 keep, 0 on parts of every ghost face and
        # on ghost edges and corners
        keep = (self.rand(rng, pad, 0.0, 1.0) > 0.2).float()
        keep[0, 0, :] = keep[-1, :, 0] = keep[:, -1, -1] = 0.0
        f, g = fs[0], ps[0]
        k1u = lambda: rbgs_solve(1, f, g, a, c, 15,  # noqa: E731
                                 keep=keep, packed=False)
        p1u = lambda: rbgs_solve_plain(1, f, g, a, c, 15,  # noqa: E731
                                       keep=keep)
        got = k1u()
        self.compare("rbgs_solve_unpacked", got, p1u(),
                     "128x64x64 ghost-zero keep")
        packed = rbgs_solve(1, f, g, a, c, 15, keep=keep)
        print(f"   rbgs_solve_unpacked vs packed on that keep: max abs diff "
              f"{float((got - packed).abs().max()):.3g} (the forms differ "
              f"there)", flush=True)
        self.time_pair("rbgs_solve_unpacked", k1u, p1u, 20)
        self.bound("rbgs_solve_unpacked", (f, g[1:-1, 1:-1, 1:-1], keep, f),
                   15 * OPS_PER_CELL["rbgs_solve_keep"] * n)
        self.kern["rbgs_solve_unpacked"]["launches"] = 0   # no route

        # K8 on a stack of 3
        vx = self.rand(rng, pad, -20.0, 40.0)
        vy, vz = (self.rand(rng, pad, -3.0, 3.0) for _ in range(2))
        stack = torch.stack([self.rand(rng, pad) for _ in range(3)])
        k8 = lambda: advect_split_fused(stack, vx, vy, vz, 0.05)  # noqa: E731
        p8 = lambda: advect_split_plain(stack, vx, vy, vz, 0.05)  # noqa: E731
        self.compare("advect_split_fused", k8(), p8(), "128x64x64 stack of 3")
        self.time_pair("advect_split_fused", k8, p8, 50)
        D2, H2 = D + 2, H + 2
        self.bound("advect_split_fused", (stack, vx, vy, vz, k8()),
                   (6 + 3 * 3) * (D2 * H2 * W + D2 * H * W + n))
        self.kern["advect_split_fused"]["launches"] = 0    # no route

    def advect_compat(self):
        """K19 against the plain call (``ops.advect.advect``) bitwise: b
        0-3, both walls, empty and with solids, at ragged shapes and on
        backtraces that clamp at every face; then at 512x256x256 (the
        bench sphere) and 128x64x64 (the flagship sphere) a velocity and a
        density call, bitwise, with its event time beside the plain call's
        and its bound, and its device time (CUDA-graph replay)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.advect_compat import (
            advect_compat)
        from fluid_simulation_tpu_torch.ops.advect import advect
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, empty_obstacles, flagship_sphere)
        from fluid_simulation_tpu_torch.tools.exp_transpose import (
            measure_body)
        torch = self.torch
        rng = np.random.default_rng(SEED + 19)
        for D, H, W in ((1, 1, 1), (9, 11, 37), (3, 2, 600)):
            pad = (D + 2, H + 2, W + 2)
            obs = empty_obstacles(W, H, D)
            obs[1:-1, 1:-1, 1:-1] = rng.uniform(size=(D, H, W)) < 0.2
            solids = build_masks(obs, device="cuda")
            vel = [self.rand(rng, pad, -12.0, 12.0) for _ in range(3)]
            vel[0][0, 0, :] = 0.0   # backtraces on exact integers
            dens = self.rand(rng, pad, 0.0, 1.0)
            for b in range(4):
                prev = dens if b == 0 else vel[b - 1] * 0.5
                for wall in ("reference", "noslip"):
                    for empty in (True, False):
                        args = (b, prev, *vel, solids, 0.1, wall, empty)
                        self.compare_bits(
                            "advect_compat", advect_compat(*args),
                            advect(*args),
                            f"{W}x{H}x{D} b={b} {wall} "
                            f"{'empty' if empty else 'solids'}")
        for (W, H, D), obs in (((512, 256, 256), big_sphere(512, 256, 256)),
                               ((128, 64, 64), flagship_sphere())):
            pad = (D + 2, H + 2, W + 2)
            m = build_masks(obs, device="cuda")
            reach = 40.0 / W
            vel = [self.rand(rng, pad, -reach, reach) * m.keep_scalar
                   for _ in range(3)]
            dens = self.rand(rng, pad, 0.0, 1.0) * m.keep_scalar
            tag = f"{W}x{H}x{D} sphere"
            for b, prev in ((1, vel[0] * 0.9), (0, dens)):
                args = (b, prev, *vel, m, 0.05)
                kf = lambda: advect_compat(*args)   # noqa: E731
                pf = lambda: advect(*args)          # noqa: E731
                self.compare_bits("advect_compat", kf(), pf(),
                                  f"{tag} b={b}")
                interior = [v[1:-1, 1:-1, 1:-1] for v in vel]
                others = interior[1:] if b else interior
                moved = (prev, *others, m.fluid_i, m.keep_scalar, kf())
                if b and W == 512:
                    # the result line's row: the big grid's velocity call
                    self.time_pair("advect_compat", kf, pf, 20, tag)
                    self.bound("advect_compat", moved,
                               OPS_PER_CELL["advect_compat"] * W * H * D)
                else:
                    print(f"   advect_compat  {tag} b={b}: kernel "
                          f"{self.event_ms(kf, 20):.4f} ms, plain "
                          f"{self.event_ms(pf, 5):.4f} ms per call",
                          flush=True)
                    self.bound("advect_compat", moved,
                               OPS_PER_CELL["advect_compat"] * W * H * D,
                               record=False)
                dev = measure_body(kf, 10, "cuda") * 1e3
                nbytes = sum(t.numel() * t.element_size() for t in moved)
                print(f"   advect_compat  {tag} b={b}: device (graph "
                      f"replay) {dev:.4f} ms, {nbytes / dev / 1e9:.3f} "
                      f"TB/s, {100 * nbytes / HBM_BYTES_PER_S / dev / 1e-3:.2f}"
                      f" % of the bound", flush=True)
            del m, vel, dens
            torch.cuda.empty_cache()

    def advect_fast(self):
        """K20 against the plain composition (``advect_fast_plain``)
        bitwise: ragged shapes with backtraces that clamp at every face,
        then 512x256x256 (the bench sphere) and 128x64x64 (the flagship
        sphere) with the saves zero in solids; at both, its device time
        (CUDA-graph replay) and share of the bound, and its event time
        beside the plain composition's."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.advect_fast import (
            advect_fast, advect_fast_plain)
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, flagship_sphere)
        from fluid_simulation_tpu_torch.tools.exp_transpose import (
            measure_body)
        torch = self.torch
        rng = np.random.default_rng(SEED + 20)
        inner = (slice(1, -1),) * 3
        for D, H, W in ((1, 1, 1), (9, 11, 37), (3, 2, 600)):
            pad = (D + 2, H + 2, W + 2)
            vel = [self.rand(rng, pad, -12.0, 12.0) for _ in range(3)]
            vel[0][1, 1, :] = 0.0   # backtraces on exact integers
            saves = [self.rand(rng, pad) for _ in range(3)]
            views = [v[inner] for v in vel]
            self.compare_bits("advect_fast", advect_fast(*views, saves, 0.1),
                              advect_fast_plain(*views, saves, 0.1),
                              f"{W}x{H}x{D}")
        for (W, H, D), obs in (((512, 256, 256), big_sphere(512, 256, 256)),
                               ((128, 64, 64), flagship_sphere())):
            pad = (D + 2, H + 2, W + 2)
            keep = build_masks(obs, device="cuda").keep_scalar
            reach = 40.0 / W
            vel = [self.rand(rng, pad, -reach, reach) * keep
                   for _ in range(3)]
            saves = [self.rand(rng, pad) * keep for _ in range(3)]
            views = [v[inner] for v in vel]
            tag = f"{W}x{H}x{D} sphere"
            kf = lambda: advect_fast(*views, saves, 0.05)        # noqa: E731
            pf = lambda: advect_fast_plain(*views, saves, 0.05)  # noqa: E731
            want = pf()
            self.compare_bits("advect_fast", kf(), want, tag)
            moved = (*views, *saves, want)
            if W == 512:
                # the result line's row: the big grid
                self.time_pair("advect_fast", kf, pf, 20, tag)
                self.bound("advect_fast", moved,
                           OPS_PER_CELL["advect_fast"] * W * H * D)
            else:
                print(f"   advect_fast    {tag}: kernel "
                      f"{self.event_ms(kf, 20):.4f} ms, plain "
                      f"{self.event_ms(pf, 5):.4f} ms per call", flush=True)
                self.bound("advect_fast", moved,
                           OPS_PER_CELL["advect_fast"] * W * H * D,
                           record=False)
            dev = measure_body(kf, 10, "cuda") * 1e3
            nbytes = sum(t.numel() * t.element_size() for t in moved)
            print(f"   advect_fast    {tag}: device (graph replay) "
                  f"{dev:.4f} ms, {nbytes / dev / 1e9:.3f} TB/s, "
                  f"{100 * nbytes / HBM_BYTES_PER_S / dev / 1e-3:.2f} % of "
                  f"the bound", flush=True)
            del keep, vel, saves, views, want, moved
            torch.cuda.empty_cache()

    def compat_window(self):
        """Compat with advect_window=1 through the entry point: the parity
        gate, the gathers' counts, bitwise equal to the window-0 run."""
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere
        base = SimParams(div_stats=False, step_stats=False)
        wt = WindTunnel(base.replace(advect_window=1), device="cuda")
        self.run_path(wt, 100, "compat window 3/2/4 per step", rbgs_solve=3,
                      project_empty=2, advect_compat=4)
        self.check_parity(wt)
        wt0 = WindTunnel(base, device="cuda")
        wt0.simulate(100)
        self.same_state(wt.state, wt0.state, "compat window 1 vs 0, 100 steps")
        self.ms_ab("compat 128x64x64", (("window 0", wt0.step),
                                        ("window 1", wt.step)), 20)
        ws = WindTunnel(base.replace(advect_window=1),
                        obstacles=flagship_sphere(), device="cuda")
        self.run_path(ws, 20, "sphere compat window", rbgs_solve_keep=3,
                      project_masked=2, advect_compat=4)
        self.check_scene(ws, "sphere compat window 128x64x64")
        ws0 = WindTunnel(base, obstacles=flagship_sphere(), device="cuda")
        ws0.simulate(20)
        self.same_state(ws.state, ws0.state,
                        "sphere compat window 1 vs 0, 20 steps")

    def fast_window(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        base = SimParams(mode="fast", div_stats=False, step_stats=False)
        wt = WindTunnel(base.replace(advect_window=1), device="cuda")
        self.run_path(wt, 100, "fast window", rbgs_solve=3, project_empty=2,
                      advect_fast=1, pad_bounds=1, advect_compat=1)
        self.check_state(wt, "fast window 128x64x64")
        wt0 = WindTunnel(base, device="cuda")
        wt0.simulate(100)
        self.same_state(wt.state, wt0.state, "fast window 1 vs 0, 100 steps")
        self.ms_ab("fast 128x64x64", (("window 0", wt0.step),
                                      ("window 1", wt.step)), 20)

    def sweep_kernels(self):
        """B15 and B20 against their plain versions: the 256^3 slab of two
        ranks with the bench sphere's keep (rank 1's slab, through the
        sphere), the 128x64x64 slab of two with the flagship sphere's (rank
        0's), a ragged 4x7x13 slab with random 0/1 solids and no-slip
        walls."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import linsolve_sweep as ks
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, flagship_sphere)

        torch = self.torch
        rng = np.random.default_rng(SEED + 5)
        small = np.zeros((6, 9, 15), np.float32)
        small[1:-1, 1:-1, 1:-1] = rng.uniform(size=(4, 7, 13)) < 0.2
        cases = ((big_sphere(256, 256, 256)[128:258], "reference", (1, 0),
                  True), (flagship_sphere()[:34], "reference", (1, 0), False),
                 (small, "noslip", (2, 3), False))
        for obs, wall, bs, main in cases:
            m = build_masks(obs, device="cuda")
            pad = tuple(obs.shape)
            Dl, H, W = (s - 2 for s in pad)
            tag = f"slab {Dl}x{H}x{W} {wall}"
            print(f"   {tag}: {int(m.solid.sum())} solid cells", flush=True)
            a, c = diffusion_coeffs(W, H, 2 * Dl, 0.05, 2e-5)
            field, prev = self.rand(rng, pad), self.rand(rng, pad)
            planes = [self.rand(rng, s) for s in ((Dl, H), (Dl, H), (Dl, W),
                                                   (Dl, W))]
            zs = [self.rand(rng, (H, W)) for _ in range(4)]
            bps = [self.rand(rng, pad[1:]) for _ in range(2)]
            fk = self.rand(rng, (Dl, H, W))
            rp = prev[1:-1, 1:-1, 1:-1]
            for b in bs:
                keep = m.keep_vel if b else m.keep_scalar
                kp = keep[1:-1, 1:-1, 1:-1]
                args = (b, fk, rp, kp, *planes, *zs, a, c, wall)
                self.compare("rbgs_sweep_packed", ks.rbgs_sweep_packed(*args),
                             ks.rbgs_sweep_packed_plain(*args),
                             f"{tag} b={b}")
                for ak in (True, False):
                    pargs = (b, field, prev, keep, *bps, a, c, wall, ak)
                    self.compare("rbgs_sweep", ks.rbgs_sweep(*pargs),
                                 ks.rbgs_sweep_plain(*pargs),
                                 f"{tag} b={b} keep={ak}")
            if main:
                kp = m.keep_vel[1:-1, 1:-1, 1:-1]
                args = (1, fk, rp, kp, *planes, *zs, a, c)
                pargs = (1, field, prev, m.keep_vel, *bps, a, c)
                shapes = f"slab {Dl}x{H}x{W}"
                self.time_pair("rbgs_sweep_packed",
                               lambda: ks.rbgs_sweep_packed(*args),
                               lambda: ks.rbgs_sweep_packed_plain(*args), 20,
                               shapes)
                self.time_pair("rbgs_sweep", lambda: ks.rbgs_sweep(*pargs),
                               lambda: ks.rbgs_sweep_plain(*pargs), 20,
                               shapes)
                n = Dl * H * W
                self.bound("rbgs_sweep_packed",
                           (fk, rp, kp, *planes, *zs,
                            *ks.rbgs_sweep_packed(*args)),
                           OPS_PER_CELL["rbgs_sweep_packed"] * n)
                self.bound("rbgs_sweep", (field, rp, m.keep_vel, *bps,
                                          field),
                           OPS_PER_CELL["rbgs_sweep"] * n)
            del m, field, prev, fk
        self.kern["rbgs_sweep"]["launches"] = 0    # no route
        torch.cuda.empty_cache()

    def retired_kernels(self):
        """B22a (the fused pre-advection block) and B22c (the blocked solve)
        through their entry points, with the counts set to 0 just before
        and read just after; then against their plain versions, the prestep
        also against the chain it replaces (K1 x3 + K2, K1 keep x3 + K6),
        at 128x64x64 with the bench sphere's masks, reference and no-slip
        walls; the blocked solve also at 256^3 with its sphere. Times,
        device times and bounds."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        from fluid_simulation_tpu_torch.kernels.linsolve_blocked import (
            rbgs_solve_blocked, rbgs_solve_blocked_plain)
        from fluid_simulation_tpu_torch.kernels.prestep import (
            grid_blocks, prestep, prestep_plain)
        from fluid_simulation_tpu_torch.kernels.project import (
            project_empty, project_masked)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, flagship_sphere)
        from fluid_simulation_tpu_torch.tools.breakdown import device_profile

        torch = self.torch
        rng = np.random.default_rng(SEED + 6)
        W, H, D = 128, 64, 64
        pad, n, acc = (D + 2, H + 2, W + 2), W * H * D, 15
        a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
        m = build_masks(flagship_sphere(), device="cuda")
        scenes = {"prestep": (None, None, None),
                  "prestep_masked": (m.fluid_i, m.keep_vel[1:-1, 1:-1, 1:-1],
                                     m.keep_vel)}
        vel = [self.rand(rng, pad) for _ in range(3)]
        f, g = self.rand(rng, pad), self.rand(rng, pad)
        print(f"   prestep cooperative grid: {grid_blocks(vel[0].device)} "
              f"blocks of 256 threads", flush=True)

        reset_launches()
        for fl, kv, _ in scenes.values():
            prestep(*vel, fl, kv, a, c, acc)
        rbgs_solve_blocked(1, f, g, m.keep_vel, a, c, acc)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        want = {k: {"prestep": 1, "prestep_masked": 1,
                    "rbgs_solve_blocked": acc}.get(k, 0) for k in counts}
        print(f"   launches of one call each: "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        self.check(counts == want, f"retired kernels: counts {counts} != "
                   f"{want}")
        for name in ("prestep", "prestep_masked", "rbgs_solve_blocked"):
            self.kern[name]["launches"] = counts[name]

        def chain(fl, kv, keep, wall):
            w = [rbgs_solve(b, v, v, a, c, acc, wall, keep)
                 for b, v in zip((1, 2, 3), vel)]
            return (project_empty(*w, acc, wall) if fl is None else
                    project_masked(*w, fl, kv, acc, wall))

        for name, (fl, kv, keep) in scenes.items():
            for wall in ("reference", "noslip"):
                got = prestep(*vel, fl, kv, a, c, acc, wall)
                tag = f"128x64x64 {wall}"
                self.compare(name, got, prestep_plain(*vel, fl, kv, a, c,
                                                      acc, wall), tag)
                self.compare(name, got, chain(fl, kv, keep, wall), tag,
                             ref="chain")
            kf = lambda: prestep(*vel, fl, kv, a, c, acc)  # noqa: E731
            pf = lambda: prestep_plain(*vel, fl, kv, a, c,  # noqa: E731
                                       acc)
            cf = lambda: chain(fl, kv, keep, "reference")  # noqa: E731
            self.time_pair(name, kf, pf, 20)
            chain_ms = self.event_ms(cf, 20)
            kd, cd = device_profile(kf, 10), device_profile(cf, 10)
            print(f"   {name:14s} chain {chain_ms:.4f} ms per call; device "
                  f"ms per call: kernel {kd['busy_ms']:.4f} in "
                  f"{kd['device_ops']:g} launch(es), chain "
                  f"{cd['busy_ms']:.4f} in {cd['device_ops']:g}", flush=True)
            self.check(kd["device_ops"] == 1.0,
                       f"{name}: {kd['device_ops']} device ops per call, "
                       f"expected one cooperative launch: {kd['top']}")
            masks = () if fl is None else (fl, kv)
            # divergence 7 and gradient 9 (masked 13 and 51) once
            extra = 16 if fl is None else 64
            self.bound(name, (*vel, *masks, *got),
                       (4 * acc * OPS_PER_CELL[name] + extra) * n)

        for obs, (Wb, Hb, Db), main in ((flagship_sphere(), (W, H, D), True),
                                        (big_sphere(256, 256, 256),
                                         (256, 256, 256), False)):
            mb = build_masks(obs, device="cuda")
            padb = (Db + 2, Hb + 2, Wb + 2)
            ab, cb = diffusion_coeffs(Wb, Hb, Db, 0.05, 2e-5)
            fb, gb = self.rand(rng, padb), self.rand(rng, padb)
            tag = f"{Wb}x{Hb}x{Db}"
            for b, keep, wall, empty in ((0, mb.keep_scalar, "reference",
                                          False),
                                         (1, mb.keep_vel, "reference", False),
                                         (2, mb.keep_vel, "noslip", False),
                                         (3, None, "noslip", True)):
                args = (b, fb, gb, keep, ab, cb, acc, wall, empty)
                self.compare("rbgs_solve_blocked", rbgs_solve_blocked(*args),
                             rbgs_solve_blocked_plain(*args),
                             f"{tag} b={b} {wall}"
                             f"{' empty' if empty else ''}")
            args = (1, fb, gb, mb.keep_vel, ab, cb, acc)
            kf = lambda: rbgs_solve_blocked(*args)  # noqa: E731
            pf = lambda: rbgs_solve_blocked_plain(*args)  # noqa: E731
            if main:
                self.time_pair("rbgs_solve_blocked", kf, pf, 20)
                self.bound("rbgs_solve_blocked",
                           (fb, gb[1:-1, 1:-1, 1:-1], mb.keep_vel, fb),
                           acc * OPS_PER_CELL["rbgs_solve_blocked"] * n)
            else:
                print(f"   rbgs_solve_blocked {tag}: kernel "
                      f"{self.event_ms(kf, 5):.4f} ms, plain "
                      f"{self.event_ms(pf, 2):.4f} ms per call", flush=True)
                self.bound("rbgs_solve_blocked",
                           (fb, gb[1:-1, 1:-1, 1:-1], mb.keep_vel, fb),
                           acc * OPS_PER_CELL["rbgs_solve_blocked"]
                           * Wb * Hb * Db, record=False)
            del mb, fb, gb
        torch.cuda.empty_cache()

    def cpack(self):
        """B22b, the colour-packed solve, through both entry points: the
        counts of one call each, then both against their plain versions,
        each other and K1 at three grids, and their times (phase 17)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        from fluid_simulation_tpu_torch.kernels.linsolve_cpack import (
            rbgs_solve_cpack, rbgs_solve_cpack_plain, rbgs_solve_cpack_stream,
            rbgs_solve_cpack_stream_plain)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            add_sphere, big_sphere, empty_obstacles, flagship_sphere)
        from fluid_simulation_tpu_torch.tools.breakdown import device_profile

        torch = self.torch
        rng = np.random.default_rng(SEED + 8)
        acc = 15
        # (interior, scene, kernel reps, plain reps, profiled calls); the
        # 256x64x64 grid is tools/exp_cpack.py:19's default, its sphere the
        # bench sphere's at the same place along the tunnel
        grids = (((128, 64, 64), flagship_sphere, 20, 5, 10),
                 ((256, 64, 64), lambda: add_sphere(
                     empty_obstacles(256, 64, 64), cx=80, cy=32, cz=32,
                     radius=10), 20, 3, 10),
                 ((256, 256, 256), lambda: big_sphere(256, 256, 256), 5, 1,
                  3))
        for (W, H, D), scene, reps, plain_reps, calls in grids:
            pad, n, main = (D + 2, H + 2, W + 2), W * H * D, W == 128
            tag = f"{W}x{H}x{D}"
            m = build_masks(scene(), device="cuda")
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            if main:
                self.cpack_counts(f, g, m.keep_vel, a, c, acc)
            errs = {}
            for b in range(4):
                for empty in (False, True):
                    keep = None if empty else (m.keep_vel if b
                                               else m.keep_scalar)
                    for wall in ("reference", "noslip"):
                        args = (b, f, g, keep, a, c, acc, wall, empty)
                        kr = rbgs_solve_cpack(*args)
                        ks = rbgs_solve_cpack_stream(*args)
                        k1 = rbgs_solve(b, f, g, a, c, acc, wall, keep)
                        for key, got, want in (
                                (("rbgs_solve_cpack", "plain"), kr,
                                 rbgs_solve_cpack_plain(*args)),
                                (("rbgs_solve_cpack", "K1"), kr, k1),
                                (("rbgs_solve_cpack_stream", "plain"), ks,
                                 rbgs_solve_cpack_stream_plain(*args)),
                                (("rbgs_solve_cpack_stream", "K1"), ks, k1),
                                (("rbgs_solve_cpack_stream", "resident"), ks,
                                 kr)):
                            errs[key] = max(errs.get(key, 0.0),
                                            self.diff(got, want))
            for (name, ref), err in errs.items():
                self.record(name, err, f"{tag} b=0..3 x2 scenes x2 walls",
                            ref)

            args = (1, f, g, m.keep_vel, a, c, acc)
            k1f = lambda: rbgs_solve(1, f, g, a, c, acc,  # noqa: E731
                                     keep=m.keep_vel)
            k1_ms, k1_dev = self.event_ms(k1f, reps), device_profile(k1f,
                                                                      calls)
            print(f"   K1 keep {tag}: event {k1_ms:.4f} ms, device "
                  f"{k1_dev['busy_ms']:.4f} ms in {k1_dev['device_ops']:g} "
                  f"ops per call", flush=True)
            self.top_ops(k1_dev)
            for name, kf, pf in (
                    ("rbgs_solve_cpack", lambda: rbgs_solve_cpack(*args),
                     lambda: rbgs_solve_cpack_plain(*args)),
                    ("rbgs_solve_cpack_stream",
                     lambda: rbgs_solve_cpack_stream(*args),
                     lambda: rbgs_solve_cpack_stream_plain(*args))):
                ms, pms = self.event_ms(kf, reps), self.event_ms(pf,
                                                                 plain_reps)
                dev = device_profile(kf, calls)
                if main:
                    self.kern[name].update(ms=ms, plain_ms=pms)
                print(f"   {name} {tag}: event {ms:.4f} ms, device "
                      f"{dev['busy_ms']:.4f} ms in {dev['device_ops']:g} ops"
                      f" per call (K1 keep {k1_ms:.4f} / {k1_dev['busy_ms']:.4f}"
                      f"); plain {pms:.4f} ms", flush=True)
                self.top_ops(dev)
                self.bound(name, (f, g[1:-1, 1:-1, 1:-1],
                                  m.keep_vel[1:-1, 1:-1, 1:-1], f),
                           acc * OPS_PER_CELL[name] * n, record=main)
            del m, f, g
        torch.cuda.empty_cache()

    def top_ops(self, prof, rows=4):
        """The costliest device operations of a ``device_profile``."""
        for name, n, ms in prof["top"][:rows]:
            print(f"      {ms:9.4f} ms {n:5.1f}x per call  {name[:70]}",
                  flush=True)

    def cpack_counts(self, f, g, keep, a, c, acc):
        """One call of each colour-packed entry point, with the counts set
        to 0 just before and read just after each."""
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.linsolve_cpack import (
            rbgs_solve_cpack, rbgs_solve_cpack_stream)
        for name, solve, want in (
                ("rbgs_solve_cpack", rbgs_solve_cpack,
                 {"rbgs_solve_keep": 1, "rbgs_solve_cpack": 1}),
                ("rbgs_solve_cpack_stream", rbgs_solve_cpack_stream,
                 {"rbgs_solve_blocked": 1,
                  "rbgs_solve_cpack_stream": acc - 1})):
            reset_launches()
            solve(1, f, g, keep, a, c, acc)
            self.torch.cuda.synchronize()
            counts = {k: v for k, v in LAUNCHES.items() if v}
            print(f"   launches of one {name} call: {counts}", flush=True)
            self.check(counts == want, f"{name}: counts {counts} != {want}")
            self.kern[name]["launches"] = counts[name]

    def overhead(self):
        """B23's exp_overhead: the tiny kernel against its plain version;
        the counts of one eager iteration of every row; every row eager
        and replayed from a CUDA graph (phase 18)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.probe import (
            add_one, add_one_plain)
        from fluid_simulation_tpu_torch.tools import exp_overhead

        torch = self.torch
        rng = np.random.default_rng(SEED + 9)
        x = self.rand(rng, (8, 128))
        self.compare("probe_add1", add_one(x), add_one_plain(x), "(8, 128)")
        self.time_pair("probe_add1", lambda: add_one(x),
                       lambda: add_one_plain(x), 200, "(8, 128)")
        self.bound("probe_add1", (x, x), OPS_PER_CELL["probe_add1"]
                   * x.numel())
        # one PyTorch call computes x + 1: torch.add
        self.kern["probe_add1"]["library_ms"] = self.event_ms(
            lambda: torch.add(x, 1.0), 200)

        rows = exp_overhead.rows("cuda")
        reset_launches()
        for row in rows:
            row.body()
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        want = {"probe_add1": 21, "rbgs_solve": 10, "project_empty": 1,
                "prestep": 1}
        print(f"   launches of one eager iteration of every row: {counts}",
              flush=True)
        self.check(counts == want, f"overhead rows: counts {counts} != "
                   f"{want}")
        self.kern["probe_add1"]["launches"] = counts["probe_add1"]
        print(f"   {'row':36s} (n = 50; replay bitwise to eager)",
              flush=True)
        for row in rows:
            r = exp_overhead.measure(row, 50)
            print(f"   {exp_overhead.format_row(r)}", flush=True)
        for launch in exp_overhead.launches("cuda"):
            split = exp_overhead.format_split(
                launch, exp_overhead.host_split(launch))
            for line in split.splitlines():
                print(f"   {line}", flush=True)

    def streamcost(self):
        """B23's exp_hbm, exp_hbm2 and exp_sweepcost (phase 19)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.hbm import (
            stream_copy, stream_copy_plain, stream_vec)
        from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
            KERNEL_NSW, sweep_pass)
        from fluid_simulation_tpu_torch.kernels.sweepcost import (
            VARIANTS, sweep_pass_variant, sweep_pass_variant_plain)
        from fluid_simulation_tpu_torch.tools import (
            exp_hbm, exp_hbm2, exp_sweepcost)

        torch = self.torch
        rng = np.random.default_rng(SEED + 10)
        a, c = exp_hbm2.PASS_A, exp_hbm2.PASS_C
        big = (256, 256, 256)
        x, y = self.rand(rng, big), self.rand(rng, big)
        reset_launches()
        stream_copy(x, y, blk=16)
        sweep_pass_variant(x, y, "full", 2, 1, a, c)
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        print(f"   launches of one stream and one variant pass: {counts}",
              flush=True)
        want = {"hbm_stream": 1, "sweepcost_pass": 1}
        self.check(counts == want, f"streamcost: counts {counts} != {want}")
        for name in want:
            self.kern[name]["launches"] = counts[name]

        # the JAX tools' eight forms: (row name, second input: None, the
        # first again or a distinct array, keywords)
        halo, chain = dict(blk=16, halo=True), dict(blk=16, halo=True,
                                                    chain=True)
        forms = (("copy1", None, dict(blk=16)),
                 ("copy1_blk32", None, dict(blk=32)),
                 ("copy2", "same", dict(blk=16)), ("copy2h", "same", halo),
                 ("sweepish", "same", chain),
                 ("copy2d", "distinct", dict(blk=16)),
                 ("copy2hd", "distinct", halo), ("arithd", "distinct", chain))
        for (D, H, W), skew in (((10, 7, 13), 0), ((40, 8, 16), 0),
                                ((40, 8, 16), 1), (big, 0)):
            tag = f"{W}x{H}x{D}" + (" misaligned" if skew else "")
            n = D * H * W
            x1 = torch.empty(n + skew, device="cuda")[skew:].view(D, H, W)
            x2 = torch.empty(n + skew, device="cuda")[skew:].view(D, H, W)
            x1.copy_(self.rand(rng, (D, H, W)))
            x2.copy_(self.rand(rng, (D, H, W)))
            for form, second, kw in forms:
                y2 = {None: None, "same": x1, "distinct": x2}[second]
                vec = stream_vec(x1, x1, y2)
                self.compare("hbm_stream", stream_copy(x1, y2, **kw),
                             stream_copy_plain(x1, y2, **kw),
                             f"{tag} {form} vec {vec}")
            del x1, x2
        for (D, H, W), b, wall in (((10, 7, 13), 2, "noslip"),
                                   (big, 1, "reference")):
            tag = f"{W}x{H}x{D}"
            f = self.rand(rng, (D, H, W))
            g = self.rand(rng, (D + 2, H + 2, W + 2))[1:-1, 1:-1, 1:-1]
            for nsw in KERNEL_NSW:
                for v in VARIANTS:
                    got = sweep_pass_variant(f, g, v, nsw, b, a, c, wall)
                    self.compare("sweepcost_pass", got,
                                 sweep_pass_variant_plain(f, g, v, nsw, b, a,
                                                          c, wall),
                                 f"{tag} {v} nsw={nsw}")
                    if v in ("full", "noiota", "coalesced"):
                        self.compare("sweepcost_pass", got,
                                     sweep_pass(f, g, None, b, a, c, nsw,
                                                wall),
                                     f"{tag} {v} nsw={nsw}", ref="rbgs_pass")
            del f, g
        n = x.numel()
        self.time_pair("hbm_stream", lambda: stream_copy(x, y, blk=16),
                       lambda: stream_copy_plain(x, y, blk=16), 20,
                       "256^3 copy2d")
        self.bound("hbm_stream", (x, y, x), OPS_PER_CELL["hbm_stream"] * n)
        # one PyTorch call computes copy2d: torch.add
        self.kern["hbm_stream"]["library_ms"] = self.event_ms(
            lambda: torch.add(x, y), 20)
        self.time_pair("sweepcost_pass",
                       lambda: sweep_pass_variant(x, y, "full", 2, 1, a, c),
                       lambda: sweep_pass_variant_plain(x, y, "full", 2, 1,
                                                        a, c), 10,
                       "256^3 full nsw=2")
        self.bound("sweepcost_pass", (x, y, x),
                   2 * OPS_PER_CELL["sweepcost_pass"] * n)
        del x, y
        torch.cuda.empty_cache()
        for tool in (exp_hbm, exp_hbm2, exp_sweepcost):
            tool.main(["--n", "10"])
            torch.cuda.empty_cache()
        exp_sweepcost.main(["--n", "10", "--shape", "512", "256", "256"])
        torch.cuda.empty_cache()

    def probes_last(self):
        """B23's exp_dma, exp_transpose and exp_solve_mxu (phase 20)."""
        import numpy as np
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.advect_split import lerp_pass
        from fluid_simulation_tpu_torch.kernels.dma import (
            DTYPES, FORMS, check_form, dma_stream, dma_stream_plain, loaders)
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        from fluid_simulation_tpu_torch.kernels.linsolve_mxu import (
            A, C, band_flops, rbgs_solve_mxu, rbgs_solve_mxu_plain)
        from fluid_simulation_tpu_torch.kernels.transpose import (
            copy_path, strided_copy, strided_copy_plain, transpose2d,
            transpose2d_plain)
        from fluid_simulation_tpu_torch.tools import (
            exp_dma, exp_solve_mxu, exp_transpose)

        torch = self.torch
        rng = np.random.default_rng(SEED + 11)
        big = (256, 256, 256)
        x, y = self.rand(rng, big), self.rand(rng, big)
        stack, vx, dtW = exp_transpose.boundary_case(big, "cuda")
        f, g = exp_solve_mxu.inputs((128, 64, 64), "cuda")
        reset_launches()
        dma_stream(x, y, form="copy2", blk=16, loader="tma")
        transpose2d(vx)
        strided_copy(vx.transpose(0, 1))
        lerp_pass(stack, vx, 2, dtW, (0, 0, 1))
        rbgs_solve_mxu(f, g, A, C, 15)
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: 1 for k in ("dma_stream", "transpose", "strided_copy",
                               "lerp_pass", "rbgs_solve_mxu")}
        print(f"   launches of one call of each: {counts}", flush=True)
        self.check(counts == want, f"probes_last: counts {counts} != {want}")
        for name in want:
            self.kern[name]["launches"] = counts[name]

        # the stream: every form, both loaders, both dtypes, blk 8 and 16
        # (and an odd 3 where the form takes it), whole and ragged z-blocks,
        # ragged tiles
        for D, H, W in ((48, 19, 200), (40, 7, 13), (37, 9, 72), big):
            tag = f"{W}x{H}x{D}"
            a32, b32 = ((x, y) if (D, H, W) == big else
                        (self.rand(rng, (D, H, W)), self.rand(rng, (D, H, W))))
            for dtype in DTYPES:
                a, b = a32.to(dtype), b32.to(dtype)
                dt = "f32" if dtype == torch.float32 else "bf16"
                for blk in (3, 8, 16):
                    for form in FORMS:
                        for loader in loaders(form):
                            kw = dict(form=form, blk=blk, loader=loader)
                            try:
                                check_form(a, **kw)
                            except ValueError:
                                continue
                            self.compare("dma_stream", dma_stream(a, b, **kw),
                                         dma_stream_plain(a, b, **kw),
                                         f"{tag} {dt} blk={blk} "
                                         f"{form}[{loader}]")
                del a, b
        # the tensor-map cache: two pairs of one shape each get their own
        # maps, the first pair's maps are found again, and a pair allocated
        # where a freed one lay gets the right result
        pairs = [tuple(self.rand(rng, (64, 32, 128)) for _ in range(2))
                 for _ in range(2)]
        for i in (0, 1, 0):
            a, b = pairs[i]
            for form in FORMS:
                kw = dict(form=form, blk=16, loader="tma")
                self.compare("dma_stream", dma_stream(a, b, **kw),
                             dma_stream_plain(a, b, **kw),
                             f"map cache: pair {i} {form}[tma]")
        del pairs, a, b
        a, b = (self.rand(rng, (64, 32, 128)) for _ in range(2))
        self.compare("dma_stream", dma_stream(a, b, form="copy2", blk=16),
                     a + b, "map cache: a new pair", ref="a + b")
        del a, b
        n = x.numel()
        self.time_pair("dma_stream",
                       lambda: dma_stream(x, y, form="copy2", blk=16),
                       lambda: dma_stream_plain(x, y, form="copy2", blk=16),
                       20, "256^3 copy2[tma] f32")
        self.bound("dma_stream", (x, y, x), OPS_PER_CELL["dma_stream"] * n)
        # one PyTorch call computes copy2: torch.add
        self.kern["dma_stream"]["library_ms"] = self.event_ms(
            lambda: torch.add(x, y), 20)
        del x, y

        # the transposes at every shape of the JAX probes
        for shape in exp_transpose.PROBE_SHAPES:
            a = self.rand(rng, shape)
            self.compare("transpose", transpose2d(a), transpose2d_plain(a),
                         f"probe {shape}")
            self.compare("transpose", transpose2d(transpose2d(a) + 1.0),
                         transpose2d_plain(transpose2d_plain(a) + 1.0),
                         f"probe {shape} round trip")
        plains = {nm: fn for nm, fn, _ in exp_transpose.probe3_forms(False)}
        for shape in exp_transpose.PROBE3_SHAPES:
            a = self.rand(rng, shape)
            for nm, fn, _ in exp_transpose.probe3_forms(True):
                name = "transpose" if nm == "major_slice_T" else \
                    "strided_copy"
                self.compare(name, fn(a), plains[nm](a), f"{nm} {shape}")
        # the strided copy's three paths and every way a view merges or
        # falls back to one element a thread
        a = self.rand(rng, (258, 16, 128))
        wide = self.rand(rng, (258, 258, 256))
        views = (
            ("store_strided", a, 2.0, "flat4"),
            ("swap01", a.transpose(0, 1), 1.0, "rows4"),
            ("strided_row", a[:, 3, :], 1.0, "rows4"),
            ("a[:, 1:3] (rank 2)", a[:, 1:3, :], 1.0, "rows4"),
            ("expand (stride 0)", a[0, 0].expand(8, 128), 1.0, "rows4"),
            ("ragged x a[..., :127]", a[..., :127], 2.0, "rows"),
            ("misaligned a[..., 1:] of 129",
             self.rand(rng, (40, 9, 129))[..., 1:], 2.0, "rows"),
            ("odd stride a[..., ::2]", a[..., ::2], 1.0, "rows"),
            ("misaligned run", a.reshape(-1)[1:4097], 2.0, "rows"),
            ("ragged run (13, 7, 5)", self.rand(rng, (13, 7, 5)), 2.0,
             "rows"),
            ("swap02", a[:8, :, :12].transpose(0, 2), 1.0, "rows"),
            ("i0 past the grid's z (70000, 2, 3)",
             self.rand(rng, (70000, 3, 5))[:, ::2, ::2], 1.0, "rows"),
            ("swap01 (258, 258, 256)", wide.transpose(0, 1), 1.0, "rows4"),
            ("store_strided (258, 258, 256)", wide, 2.0, "flat4"),
        )
        for label, v, scale, path in views:
            got = copy_path(v)
            self.check(got == path, f"strided_copy {label}: path {got}, "
                       f"expected {path}")
            self.compare("strided_copy", strided_copy(v, scale),
                         strided_copy_plain(v, scale), f"[{path}] {label}")
        del views, wide
        self.time_pair("strided_copy",
                       lambda: strided_copy(a.transpose(0, 1)),
                       lambda: strided_copy_plain(a.transpose(0, 1)), 50,
                       "swap01 (258, 16, 128)")
        self.bound("strided_copy", (a, a), 0)
        self.kern["strided_copy"]["library_ms"] = self.event_ms(
            lambda: a.transpose(0, 1).contiguous(), 50)
        ms = self.event_ms(lambda: strided_copy(a, 2.0), 50)
        lib = self.event_ms(lambda: a * 2.0, 50)
        print(f"   strided_copy   store_strided (258, 16, 128): kernel "
              f"{ms:.4f} ms, a * 2 {lib:.4f} ms per call (events; the "
              f"probe3 rows below are graph replays)", flush=True)

        # the boundary rows: each pass against its plain version, the y
        # pass by transposes against K3's direct y pass
        kp, pp = exp_transpose.passes(True), exp_transpose.passes(False)
        for shape in ((13, 7, 5), big):
            W, H, D = shape
            tag = f"{W}x{H}x{D}"
            st, v, dtW = ((stack, vx, dtW) if shape == big else
                          exp_transpose.boundary_case(shape, "cuda"))
            A3 = kp[0](st, v, dtW)
            self.compare("lerp_pass", A3, pp[0](st, v, dtW), f"{tag} xpass")
            Bn, D2, H2, Wd = A3.shape
            flat = A3.reshape(Bn * D2, H2, Wd)
            At = transpose2d(flat)
            self.compare("transpose", At, transpose2d_plain(flat),
                         f"{tag} stack (3*D2, H2, W)")
            At = At.reshape(Bn, D2, Wd, H2)
            vT = transpose2d(v)
            self.compare("transpose", vT, transpose2d_plain(v),
                         f"{tag} velocity")
            self.compare("lerp_pass", kp[2](At, vT, dtW), pp[2](At, vT, dtW),
                         f"{tag} ypass_alone")
            direct = kp[3](A3, v, dtW)
            self.compare("lerp_pass", direct, pp[3](A3, v, dtW),
                         f"{tag} ypass_direct")
            self.compare("lerp_pass", kp[1](A3, v, dtW), direct,
                         f"{tag} ypass_T", ref="K3 y pass")
            if shape == big:
                self.time_pair("transpose", lambda: transpose2d(flat),
                               lambda: transpose2d_plain(flat), 10,
                               "256^3 stack (774, 258, 256)")
                self.bound("transpose", (flat, flat), 0)
                self.kern["transpose"]["library_ms"] = self.event_ms(
                    lambda: flat.permute(0, 2, 1).contiguous(), 10)
                self.time_pair("lerp_pass", lambda: kp[2](At, vT, dtW),
                               lambda: pp[2](At, vT, dtW), 10,
                               "256^3 ypass_alone")
                out = kp[2](At, vT, dtW)
                self.bound("lerp_pass", (At, vT, out),
                           OPS_PER_CELL["lerp_pass"] * out[0].numel())
                del out
            del A3, flat, At, vT, direct
        del stack, vx
        torch.cuda.empty_cache()

        # the tensor-core solve against its plain version and K1 unpacked
        for shape, acc in (((128, 64, 64), 15), ((13, 7, 5), 4)):
            W, H, D = shape
            tag = f"{W}x{H}x{D} acc={acc}"
            fs, gs = ((f, g) if shape == (128, 64, 64) else
                      exp_solve_mxu.inputs(shape, "cuda"))
            got = rbgs_solve_mxu(fs, gs, A, C, acc)
            self.compare("rbgs_solve_mxu", got,
                         rbgs_solve_mxu_plain(fs, gs, A, C, acc), tag)
            self.compare("rbgs_solve_mxu", got,
                         rbgs_solve(0, fs, gs, A, C, acc, packed=False), tag,
                         ref="K1 unpacked")
        self.time_pair("rbgs_solve_mxu",
                       lambda: rbgs_solve_mxu(f, g, A, C, 15),
                       lambda: rbgs_solve_mxu_plain(f, g, A, C, 15), 20)
        k1 = self.event_ms(lambda: rbgs_solve(0, f, g, A, C, 15,
                                              packed=False), 20)
        print(f"   K1 unpacked 128x64x64 acc=15: {k1:.4f} ms per call",
              flush=True)
        n = 128 * 64 * 64
        self.bound("rbgs_solve_mxu", (f, g[1:-1, 1:-1, 1:-1], f),
                   15 * OPS_PER_CELL["rbgs_solve_mxu"] * n)
        band, dense = band_flops(f.shape, 15)
        print(f"   rbgs_solve_mxu tensor-core flops a solve: band {band:.4g}"
              f", dense {dense:.4g}", flush=True)
        del f, g

        exp_dma.main(["--n", "10"])
        torch.cuda.empty_cache()
        for mode in ("probe", "probe3", "boundary"):
            exp_transpose.main([mode, "--n", "10"])
            torch.cuda.empty_cache()
        exp_solve_mxu.main([])

    def stitched(self, sw):
        """A sharded run's state stitched to the single-card layout, read
        as ``check_state``, ``check_scene`` and ``check_parity`` read a
        WindTunnel."""
        from types import SimpleNamespace
        torch = self.torch
        state = sw.global_state()
        solid = torch.tensor(sw.obstacles >= 0.5, dtype=torch.float32,
                             device=state.vx.device)
        dens = state.dens
        return SimpleNamespace(
            state=state, masks=SimpleNamespace(solid=solid),
            density_sum=lambda: float(torch.sum(dens, dtype=torch.float32)),
            field_ranges=lambda: {"density": (float(dens.min()),
                                              float(dens.max()))})

    def against_single(self, sw, wt, label, bound=5e-5):
        """The stitched sharded state against a single-card run's: max
        |difference| per field within ``bound``·max|field|."""
        got = sw.global_state()
        worst = 0.0
        for name, a, b in zip(("vx", "vy", "vz", "dens"), got, wt.state):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            worst = max(worst, err / max(scale, 1e-12))
            print(f"   {label} {name}: max|sharded-single| = {err:.3g}, "
                  f"max|field| = {scale:.4g}", flush=True)
            self.check(err <= bound * scale, f"{label} {name}: {err} > "
                       f"{bound}·{scale}")
        print(f"   {label}: worst {worst:.3g} of max|field| (bound {bound})",
              flush=True)

    def sharded(self):
        """The sharded tunnel through its entry point, every rank on the
        one card."""
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.parallel import ShardedWindTunnel
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, flagship_sphere)

        torch = self.torch
        base = SimParams(div_stats=False, step_stats=False)
        # (a) 256^3 split over two slabs, empty and with the bench sphere
        p = base.replace(width=256, height=256, depth=256, mode="split")
        for sphere in (False, True):
            label = "sharded split 256^3 / 2" + (" sphere" if sphere else "")
            obs = big_sphere(256, 256, 256) if sphere else None
            sw = ShardedWindTunnel(p, obstacles=obs,
                                   devices=["cuda:0"] * 2)
            print(f"   ranks' devices: {[str(d) for d in sw.devices]}",
                  flush=True)
            print(f"   {sw.backend_report()}", flush=True)
            self.run_path(sw, 4, label, rbgs_sweep_packed=5 * p.acc * 2)
            view = self.stitched(sw)
            if sphere:
                self.check_scene(view, label, twin="sharded split 256^3 / 2")
            else:
                self.check_state(view, label)
                self.twin_sums[label] = view.density_sum()
            wt = WindTunnel(p, obstacles=obs, device="cuda")
            wt.simulate(4)
            self.against_single(sw, wt, f"{label} vs single card (streamed)")
            del wt, view
            ms = self.event_ms(sw.step, 2)
            print(f"   {label}: {ms:.4f} ms/step ({p.n_cells / ms * 1e3:.4g} "
                  f"cell-updates/s)", flush=True)
            del sw
            torch.cuda.empty_cache()
        # (b) compat 128x64x64 over two slabs through the parity gate
        sw = ShardedWindTunnel(base, devices=["cuda:0"] * 2)
        self.run_path(sw, 100, "sharded compat 128x64x64 / 2",
                      rbgs_sweep_packed=5 * base.acc * 2)
        self.check_parity(self.stitched(sw))
        ms = self.event_ms(sw.step, 5)
        print(f"   sharded compat 128x64x64 / 2: {ms:.4f} ms/step",
              flush=True)
        # (c) split with the bench sphere over four slabs
        p = base.replace(mode="split")
        sw = ShardedWindTunnel(p, obstacles=flagship_sphere(),
                               devices=["cuda:0"] * 4)
        label = "sharded sphere split 128x64x64 / 4"
        self.run_path(sw, 20, label, rbgs_sweep_packed=5 * p.acc * 4)
        self.check_scene(self.stitched(sw), label)
        wt = WindTunnel(p, obstacles=flagship_sphere(), device="cuda")
        wt.simulate(20)
        self.against_single(sw, wt, f"{label} vs single card")
        # (d) one step of the kernel path against the plain sharded step
        plain = ShardedWindTunnel(p.replace(use_pallas=False),
                                  obstacles=flagship_sphere(),
                                  devices=["cuda:0"] * 4)
        plain.state = [type(st)(*(f.clone() for f in st)) for st in sw.state]
        sw.step()
        plain.step()
        self.same_state(sw.global_state(), plain.global_state(),
                        f"{label}: 1 step kernel path vs use_pallas=False")

    def lerpcost(self):
        """B24's exp_lerpcost (phase 21)."""
        import numpy as np
        import torch.nn.functional as F
        from fluid_simulation_tpu_torch.kernels import (
            LAUNCHES, reset_launches)
        from fluid_simulation_tpu_torch.kernels.lerpcost import (
            VARIANTS, lerpcost_pass, lerpcost_pass_plain)
        from fluid_simulation_tpu_torch.tools import exp_lerpcost

        torch = self.torch
        rng = np.random.default_rng(SEED + 12)

        def one_call(arr, xb, label):
            reset_launches()
            lerpcost_pass(arr, xb, "full")
            torch.cuda.synchronize()
            counts = {k: v for k, v in LAUNCHES.items() if v}
            print(f"   launches of one {label} call: {counts}", flush=True)
            want = {"lerpcost_pass": 1}
            self.check(counts == want,
                       f"lerpcost {label}: counts {counts} != {want}")
            return counts["lerpcost_pass"]

        arr = self.rand(rng, (3, 37, 200))
        xb = self.rand(rng, (37, 198), -1.0, 200.0)
        one_call(arr, xb, "(3, 37, 200)")
        for v in VARIANTS:
            self.compare("lerpcost_pass", lerpcost_pass(arr, xb, v),
                         lerpcost_pass_plain(arr, xb, v),
                         f"(3, 37, 200) {v}")
        # 256^3 x-geometry on a random stack: every lane differs, so a
        # wrong gather index, row, field or window offset shows
        R, C, Co = 258 * 258, 258, 256
        x0 = self.rand(rng, (3, R, C))
        planes = exp_lerpcost.planes(R, C, Co, "cuda")
        self.kern["lerpcost_pass"]["launches"] = one_call(
            x0, planes[1][1], "256^3")
        for label, plane in planes:
            for v in VARIANTS:
                self.compare("lerpcost_pass", lerpcost_pass(x0, plane, v),
                             lerpcost_pass_plain(x0, plane, v),
                             f"256^3 {v} xb={label}")
        k3 = exp_lerpcost.rows("cuda")[-1]       # K3's own x pass, 256^3
        self.compare("lerp_pass", k3.kernel(k3.x0), k3.plain(k3.x0),
                     f"256^3 {k3.name} xb={k3.xb}")
        del k3
        plane = planes[1][1]
        got = lerpcost_pass(x0, plane, "full")
        self.time_pair("lerpcost_pass",
                       lambda: lerpcost_pass(x0, plane, "full"),
                       lambda: lerpcost_pass_plain(x0, plane, "full"), 10,
                       "256^3 full, random stack and xb")
        self.bound("lerpcost_pass", (x0, plane, got),
                   OPS_PER_CELL["lerpcost_pass"] * plane.numel())
        # the one PyTorch call that computes full's samples: grid_sample
        # along x of each row (H = 1, so the row index is exact), the index
        # mapped to [-1, 1] (align_corners: -1 is lane 0); that map rounds,
        # so it agrees with full within a tolerance, not bitwise
        grid = torch.stack([plane * (2.0 / (C - 1)) - 1.0,
                            torch.zeros_like(plane)], dim=-1)[:, None]
        inp = x0.permute(1, 0, 2)[:, :, None, :]
        lib = lambda: F.grid_sample(  # noqa: E731
            inp, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
        lib_err = float((lib()[:, :, 0, :].permute(1, 0, 2) - got).abs()
                        .max())
        self.check(lib_err <= 1e-3, f"lerpcost: grid_sample differs from "
                   f"full by {lib_err:.3g} > 1e-3")
        lib_ms = self.event_ms(lib, 10)
        self.kern["lerpcost_pass"]["library_ms"] = lib_ms
        print(f"   grid_sample    256^3 full, random stack and xb: "
              f"{lib_ms:.4f} ms per call, max|grid_sample-kernel| = "
              f"{lib_err:.3g} (tolerance 1e-3: the index through [-1, 1] "
              f"rounds; never on a path)", flush=True)
        del x0, planes, plane, got, grid, inp
        torch.cuda.empty_cache()
        exp_lerpcost.main(["--n", "10"])
        torch.cuda.empty_cache()

    def stats(self):
        """The step's statistics (``kernels/stats.py``) against their plain
        version at 128x64x64 and 512x256x256, empty and with the bench
        sphere, on step-like random fields: max_divergence bitwise, the
        density sum within 2e-6 of a float64 sum and the same bits over 5
        calls; a statistic that is off NaN; a NaN or inf in one velocity
        cell a non-finite max_divergence; the kernel's time beside the
        plain version's and its bound. Then a split step with both
        statistics on, counted: one ``step_stats`` launch a step, and the
        kernel path's statistics against the plain path's over 3 steps."""
        import numpy as np
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.kernels.stats import (
            step_stats, step_stats_plain)
        from fluid_simulation_tpu_torch.models.windtunnel import (
            simulation_step)
        from fluid_simulation_tpu_torch.scene.masks import build_masks
        from fluid_simulation_tpu_torch.scene.primitives import (
            empty_obstacles)
        from fluid_simulation_tpu_torch.scene.primitives import (
            big_sphere, flagship_sphere)
        torch = self.torch
        rng = np.random.default_rng(SEED)
        for (W, H, D) in ((128, 64, 64), (512, 256, 256)):
            pad = (D + 2, H + 2, W + 2)
            for sphere in (False, True):
                obs = ((flagship_sphere() if W == 128 else
                        big_sphere(W, H, D)) if sphere
                       else empty_obstacles(W, H, D))
                m = build_masks(obs, device="cuda")
                tag = f"{W}x{H}x{D}" + (" sphere" if sphere else " empty")
                vel = self.step_like(rng, pad, m.keep_scalar if sphere
                                     else None)
                dens = self.rand(rng, pad, 0.0, 0.05)
                args = (*vel, dens, m)
                kf = lambda: step_stats(*args, not sphere)   # noqa: E731
                pf = lambda: step_stats_plain(*args)         # noqa: E731
                got, want = kf(), pf()
                self.compare("step_stats", got[1], want[1],
                             f"{tag} max_divergence")
                exact = float(dens.double().sum())
                rel = abs(float(got[0]) - exact) / exact
                rel_torch = abs(float(want[0]) - exact) / exact
                again = [kf()[0] for _ in range(5)]
                same = all(torch.equal(a, got[0]) for a in again)
                print(f"   step_stats     {tag:34s} density_sum "
                      f"{float(got[0])!r} vs float64 {exact!r}: rel "
                      f"{rel:.3g} (torch.sum {rel_torch:.3g}; bound 2e-6)"
                      f", 5 calls the same bits: {same}", flush=True)
                self.check(rel <= 2e-6 and same,
                           f"step_stats {tag}: density sum rel {rel}, "
                           f"same bits {same}")
                if W == 128 and sphere:
                    self.stats_edges(step_stats, args, got, tag)
                # the result line's row: 512x256x256 with the sphere
                row = W == 512 and sphere
                if row:
                    self.time_pair("step_stats", kf, pf, 20, tag)
                else:
                    print(f"   step_stats     {tag}: kernel "
                          f"{self.event_ms(kf, 20):.4f} ms, plain "
                          f"{self.event_ms(pf, 20):.4f} ms per call",
                          flush=True)
                fl = (m.fluid_i,) if sphere else ()
                self.bound("step_stats", (*vel, dens, *fl, got[0], got[1]),
                           OPS_PER_CELL["step_stats"] * W * H * D, row)
                del m, vel, dens, args, got, want, again
            torch.cuda.empty_cache()
        wt = WindTunnel(SimParams(mode="split"), obstacles=flagship_sphere(),
                        device="cuda")
        self.run_path(wt, 10, "split sphere with its statistics",
                      rbgs_solve_keep=3, project_masked=2, advect_split=2,
                      pad_bounds_masked=2, step_stats=1)
        kern = plain = wt.state
        plain_p = wt.params.replace(use_pallas=False)
        for i in range(3):
            kern, ks = simulation_step(kern, wt.masks, wt.params)
            plain, ps = simulation_step(plain, wt.masks, plain_p)
            rel = abs(float(ks.density_sum) - float(ps.density_sum)) / abs(
                float(ps.density_sum))
            print(f"   step {i + 1} kernel path vs plain path: "
                  f"max_divergence {float(ks.max_divergence)!r} / "
                  f"{float(ps.max_divergence)!r}, density_sum rel {rel:.3g}",
                  flush=True)
            self.check(torch.equal(ks.max_divergence, ps.max_divergence)
                       and rel <= 2e-6, f"step {i + 1}: statistics differ")

    def stats_edges(self, step_stats, args, got, tag):
        """A statistic that is off is NaN and the other unchanged; a NaN or
        inf in one fluid velocity cell gives a non-finite max_divergence."""
        torch = self.torch
        for div_on, sum_on in ((True, False), (False, True), (False, False)):
            a = step_stats(*args, False, div_on, sum_on)
            for on, x, full in ((sum_on, a[0], got[0]),
                                (div_on, a[1], got[1])):
                ok = torch.equal(x, full) if on else bool(torch.isnan(x))
                self.check(ok, f"step_stats {tag} flags ({div_on}, "
                           f"{sum_on}): {float(x)!r}")
        for value in (float("nan"), float("inf")):
            for field in range(3):
                bad = [t.clone() for t in args[:4]]
                bad[field][5, 6, 7] = value
                x = step_stats(*bad, args[4], False)[1]
                self.check(not bool(torch.isfinite(x)),
                           f"step_stats {tag}: {value} in field {field} "
                           f"gave max_divergence {float(x)!r}")
        print(f"   step_stats     {tag}: flags off give NaN, NaN and inf "
              f"in a velocity a non-finite max_divergence", flush=True)

    def times(self):
        from fluid_simulation_tpu_torch import WindTunnel
        from fluid_simulation_tpu_torch.tools.breakdown import cells
        reps = {"split 128x64x64": 50, "compat 128x64x64": 20,
                "split 256x128x128": 10, "split 128x64x64 sphere": 50,
                "split 128x64x64 noslip+vorticity": 50}
        todo = cells()
        for label, n in reps.items():
            p, obs = todo[label]
            runs = {True: [], False: []}
            for use_kernels in (True, False, False, True):
                wt = WindTunnel(p.replace(use_pallas=use_kernels),
                                obstacles=obs, device="cuda")
                wt.simulate(3)   # warm up (and leave the all-zero state)
                runs[use_kernels].append(self.event_ms(wt.step, n))
            k_ms = sum(runs[True]) / 2
            p_ms = sum(runs[False]) / 2
            n_cells = p.n_cells
            print(f"   {label}: kernel path {k_ms:.4f} ms/step "
                  f"({n_cells / k_ms * 1e3:.4g} cell-updates/s; runs "
                  f"{runs[True][0]:.4f}, {runs[True][1]:.4f}), plain path "
                  f"{p_ms:.4f} ms/step ({n_cells / p_ms * 1e3:.4g} "
                  f"cell-updates/s; runs {runs[False][0]:.4f}, "
                  f"{runs[False][1]:.4f})", flush=True)


# (key for --only, title, Smoke method), in the order they run
PHASES = [
    ("kernels", "kernels vs plain", "kernels"),
    ("obstacle_kernels", "kernels vs plain: obstacle and vorticity kernels",
     "obstacle_kernels"),
    ("stream_kernels", "kernels vs plain: streamed big-grid kernels",
     "stream_kernels"),
    ("split", "split flagship 128x64x64, 100 steps", "split_flagship"),
    ("compat", "compat parity 128x64x64, 100 steps", "compat_parity"),
    ("sphere_split", "sphere split 128x64x64, 100 steps", "sphere_split"),
    ("sphere_compat", "sphere compat 128x64x64, 20 steps", "sphere_compat"),
    ("stl", "STL scene split 128x64x64, 100 steps", "stl_split"),
    ("noslip", "noslip+vorticity split 128x64x64, 100 steps",
     "noslip_vorticity"),
    ("big_grids", "big grids: the bench's six configs, streamed",
     "big_grids"),
    ("route_times", "big grids: per-call times of both routes",
     "route_times"),
    ("variant_kernels", "kernels vs plain: trilinear gather and the variants",
     "variant_kernels"),
    ("advect_compat", "kernels vs plain: compat advection in one launch "
     "(K19)", "advect_compat"),
    ("advect_fast", "kernels vs plain: fast's velocity in one launch (K20)",
     "advect_fast"),
    ("compat_window", "compat with advect_window=1, 100 steps",
     "compat_window"),
    ("fast_window", "fast with advect_window=1, 100 steps", "fast_window"),
    ("sweep_kernels", "kernels vs plain: the sharded solve's sweeps",
     "sweep_kernels"),
    ("retired_kernels", "kernels vs plain: the fused prestep and the "
     "blocked solve", "retired_kernels"),
    ("sharded", "ShardedWindTunnel, every rank on one card", "sharded"),
    ("cpack", "kernels vs plain: the colour-packed solve", "cpack"),
    ("overhead", "launch overhead: eager against CUDA-graph replay",
     "overhead"),
    ("streamcost", "streaming ceilings and the pass kernel's cost split",
     "streamcost"),
    ("probes_last", "DMA-issue, transpose and tensor-core probes",
     "probes_last"),
    ("lerpcost", "the degrade variants of K3's stacked x pass", "lerpcost"),
    ("stats", "kernels vs plain: the step's statistics", "stats"),
    ("times", "times", "times"),
]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if argv[0] != "--only" or not set(argv[1:]) <= {p[0] for p in PHASES}:
            print(f"usage: chip_smoke.py [--only PHASE ...], PHASE in "
                  f"{[p[0] for p in PHASES]}", file=sys.stderr)
            return 2
        only = set(argv[1:])
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "fluid_simulation_tpu_torch")):
        print("chip_smoke.py: the fluid_simulation_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke.py: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, here)

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)
    smoke = Smoke(torch)

    def build():
        from fluid_simulation_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        print(f"   kernels built/loaded in {time.perf_counter() - t0:.1f} s:"
              f" {lib_path}", flush=True)
        log = (lib_path.parent / "nvcc.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Function" in line:
                    print(f"   nvcc: {line.strip()}", flush=True)

    smoke.phase("build", build)
    if smoke.failures:
        print(f"chip_smoke.py: FAILED phases: {smoke.failures}",
              file=sys.stderr)
        return 1
    phases = PHASES if only is None else [ph for ph in PHASES
                                          if ph[0] in only]
    for _, title, method in phases:
        smoke.phase(title, getattr(smoke, method))
    if smoke.failures:
        print(f"chip_smoke.py: FAILED phases: {smoke.failures}",
              file=sys.stderr)
        return 1
    if only is not None:
        print(f"chip_smoke.py: phases {sorted(only)} passed (a partial run "
              f"prints no result line)", flush=True)
        return 0

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 **{k: smoke.kern[name][k] for k in keys})
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
