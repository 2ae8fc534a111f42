"""Where K3's stacked x pass spends its time on the card: the pass with its
gather replaced one part at a time, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_lerpcost [--device cuda]
        [--shape W H D] [--n 10]

Port of ``tools/exp_lerpcost.py`` (ROADMAP B24), which timed the degrade
variants of the TPU's stacked lane-lerp pass at 256^3 x-geometry. Here, at
the x-geometry of ``--shape`` (W, H, D) (default 256^3): Bn = 3 fields,
R = (D+2)(H+2) rows, C = W+2 source lanes, Co = W outputs. Its rows:

- each variant of ``kernels/lerpcost.py`` (``full``, ``gather1``,
  ``nogather``, ``copy``) on the tool's own inputs (stack 0.5 and ``xb``
  77.3 everywhere, :61-62: every thread reads the same lanes), then on a
  seeded random ``xb`` over [0, C-1], whose gathers scatter as a run's do;
- ``k3_xpass``: K3's own x pass (``kernels/advect_split.lerp_pass``) at
  the same geometry on ``exp_transpose.boundary_case``: the production
  pass, whose coordinate comes from a velocity.

Each row prints the kernel alone (a chain of calls on fixed inputs), the
kernel plus the tool's two-lane re-pad (``c = repad(row(c))``, the tool's
scan body), and its plain version alone; on the card also its bytes (the
stack's lanes it reads, the index plane and the output, each once: copy and
gather1 read the first 128 lanes of a row, the others all C), the bound
those bytes give at 3.35 TB/s and the rate. A time is JAX's slope: the
chains of n and 3n calls are each one captured CUDA graph, ``(t(3n) -
t(n)) / 2n``, best of 3 (``tools/_timing.replay_slope``). ``--device
cpu`` runs the plain versions on the host clock (a test runs it tiny); it
prints no device metric.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels.advect_split import (
    lerp_pass, lerp_pass_plain)
from fluid_simulation_tpu_torch.kernels.lerpcost import (
    LANES, VARIANTS, lerpcost_pass, lerpcost_pass_plain)
from fluid_simulation_tpu_torch.tools import exp_hbm
from fluid_simulation_tpu_torch.tools._timing import (
    HBM_BYTES_PER_S, clock_line)
from fluid_simulation_tpu_torch.tools.exp_transpose import (
    boundary_case, measure_body)

STACK_TOOL, XB_TOOL = 0.5, 77.3     # tools/exp_lerpcost.py:61-62
BN = 3


@dataclass
class Row:
    """One probe row: ``kernel`` and ``plain`` map a (Bn, R, C) stack to
    its (Bn, R, Co) pass, from ``x0``; ``nbytes`` is what the pass must
    move."""
    name: str
    xb: str
    kernel: Callable[[torch.Tensor], torch.Tensor]
    plain: Callable[[torch.Tensor], torch.Tensor]
    x0: torch.Tensor
    nbytes: int


def repad(o: torch.Tensor) -> torch.Tensor:
    """The tool's re-pad of a (Bn, R, Co) pass to (Bn, R, Co + 2): its edge
    lanes repeated, so that the scan feeds it back at the same shape."""
    return torch.cat([o[:, :, :1], o, o[:, :, -1:]], dim=2)


def planes(R: int, C: int, Co: int, device="cuda", seed=0):
    """The probe's two (R, Co) index planes, ``(label, xb)``: the tool's
    (every xb 77.3) and a seeded random one over [0, C-1]."""
    return (("tool", torch.full((R, Co), XB_TOOL, device=device)),
            ("random", torch.tensor(np.random.default_rng(seed).uniform(
                0.0, C - 1, (R, Co)).astype(np.float32), device=device)))


def rows(device="cuda", shape=(256, 256, 256), seed=0) -> List[Row]:
    """The probe's rows at the x-geometry of ``shape`` (W, H, D)."""
    W, H, D = shape
    R, C, Co = (D + 2) * (H + 2), W + 2, W
    arr = torch.full((BN, R, C), STACK_TOOL, device=device)
    out = []
    for label, xb in planes(R, C, Co, device, seed):
        for v in VARIANTS:
            lanes = C if v in ("full", "nogather") else LANES
            out.append(Row(
                v, label, functools.partial(lerpcost_pass, xb=xb, variant=v),
                functools.partial(lerpcost_pass_plain, xb=xb, variant=v),
                arr, 4 * (BN * R * lanes + R * Co + BN * R * Co)))
    stack, vx, dtW = boundary_case(shape, device, seed)

    def xpass(fn):
        return lambda c: fn(c.view(BN, D + 2, H + 2, C), vx, 2, dtW,
                            (0, 0, 1)).view(BN, R, Co)

    out.append(Row("k3_xpass", "velocity", xpass(lerp_pass),
                   xpass(lerp_pass_plain), stack.view(BN, R, C),
                   4 * (BN * R * C + R * Co + BN * R * Co)))
    return out


def measure_row(row: Row, n: int, device) -> dict:
    """Seconds per call of the kernel alone, the kernel plus the re-pad, and
    the plain version alone."""
    return {"alone": measure_body(lambda: row.kernel(row.x0), n, device),
            "repad": exp_hbm.measure(lambda c: repad(row.kernel(c)), row.x0,
                                     n, device),
            "plain": measure_body(lambda: row.plain(row.x0), n, device)}


def format_row(row: Row, t: dict, on_card: bool) -> str:
    head = (f"{row.name:9s} xb={row.xb:8s} {t['alone'] * 1e6:10.2f} us  "
            f"+repad {t['repad'] * 1e6:10.2f} us  plain "
            f"{t['plain'] * 1e6:10.2f} us")
    if not on_card:
        return head + "  (host clock; no rate)"
    bound = row.nbytes / HBM_BYTES_PER_S
    return (f"{head}  {row.nbytes / 1e6:8.2f} MB  bound {bound * 1e6:8.2f} "
            f"us  {row.nbytes / t['alone'] / 1e9:7.1f} GB/s")


def main(argv=None) -> int:
    args = exp_hbm.parse(argv, __doc__)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_lerpcost {W}x{H}x{D} x-geometry (Bn {BN}, R "
          f"{(D + 2) * (H + 2)}, C {W + 2}, Co {W}): "
          f"{clock_line('exp_lerpcost', device)}, n = {args.n}", flush=True)
    on_card = device.type == "cuda"
    for row in rows(device, tuple(args.shape)):
        print(format_row(row, measure_row(row, args.n, device), on_card),
              flush=True)
        if on_card:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
