"""The streaming ceiling on the card with DISTINCT operands, and the
production 1-sweep pass beside it, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_hbm2 [--device cuda]
        [--shape W H D] [--n 10]

Port of ``tools/exp_hbm2.py`` (ROADMAP B23). Its rows, under its names and
in its order, each ``c = row(c, r)`` from ``c = 0.1`` everywhere with
``r = 1.5c + 0.25`` made once, a distinct array (``exp_hbm.py:59-61``):

- ``copy2d``: ``o = c + r`` (``kernels/hbm.py``);
- ``copy2hd``: ``o = ((c + r) + clo[0]) + chi[0]`` with 8-plane lo/hi
  windows on both inputs;
- ``arithd``: ``copy2hd`` with the 14-step ``acc*1.0001 + r`` chain;
- ``prod1``: the production pass at nsw 1, ``rbgs_pass<1>`` through
  ``kernels/linsolve_stream.sweep_pass``: empty scene, b = 1, reference
  walls, a = 1e-4, c = 1.0006 (``exp_hbm2.py:111-112``), the carry ``c``
  and the rhs ``r``.

Times and rates as ``exp_hbm`` prints them (JAX bytes: 3, 5, 5 and 5
arrays). ``prod1``'s issued bytes are its z-march's ring loads of the
carry and the rhs (each block's window once a plane) and the store
(``pass_issued_bytes``). The rows'
inputs are distinct, so ``copy2d`` and ``copy2hd`` are the ceilings of the
pattern; ``exp_sweepcost`` holds the pass kernel's variants against
``copy2hd``.
"""

from __future__ import annotations

from typing import List

import torch

from fluid_simulation_tpu_torch.kernels.hbm import HB
from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    MARCH_CHUNK, MARCH_TILE, pass_plain, sweep_pass)
from fluid_simulation_tpu_torch.tools import exp_hbm
from fluid_simulation_tpu_torch.tools._timing import clock_line

# exp_hbm2.py:111-112: the production call's coefficients and field
PASS_B, PASS_A, PASS_C = 1, 1e-4, 1.0006


def _clipped(n: int, t: int, m: int) -> int:
    """Cells inside [0, n) of every tile window [k*t - m, k*t + t + m)."""
    return sum(max(0, min(k * t + t + m, n) - max(k * t - m, 0))
               for k in range(-(-n // t)))


def pass_issued_bytes(shape, nsw: int) -> int:
    """Bytes an empty-scene pass of ``rbgs_pass<nsw>`` loads and stores on a
    (D, H, W) f32 carry: every block reads the carry and the rhs once at
    each cell of its ring planes inside the domain (its tile with a halo
    of 2*nsw in x and y, its planes with 2*nsw more at each end), and
    writes each output cell once."""
    m = 2 * nsw
    cells = 1
    # (W, H, D) against rbgs_tile.cuh's kTx, kTy, kChunk
    for n, t in zip(reversed(shape), MARCH_TILE[nsw] + (MARCH_CHUNK,)):
        cells *= _clipped(n, t, m)
    D, H, W = shape
    return 4 * (2 * cells + D * H * W)


def rows(device="cuda", shape=(256, 256, 256)) -> List[exp_hbm.Row]:
    """The tool's rows in its order (``shape`` is (W, H, D))."""
    W, H, D = shape
    c0 = torch.full((D, H, W), 0.1, device=device)
    r = c0 * 1.5 + 0.25
    A = c0.numel() * c0.element_size()
    prod1 = exp_hbm.Row(
        "prod1", lambda c: sweep_pass(c, r, None, PASS_B, PASS_A, PASS_C, 1),
        c0, 3 + 4 * HB / exp_hbm.BLK, pass_issued_bytes((D, H, W), 1), 3 * A,
        plain=lambda c: pass_plain(c, r, None, PASS_B, PASS_A, PASS_C, 1))
    return exp_hbm.stream_rows(c0, r) + [prod1]


def main(argv=None) -> int:
    args = exp_hbm.parse(argv, __doc__)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_hbm2 {W}x{H}x{D}: {clock_line('exp_hbm2', device)}, "
          f"n = {args.n}", flush=True)
    exp_hbm.run(rows(device, tuple(args.shape)), args.n, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
