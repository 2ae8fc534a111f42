"""The RBGS x-neighbour pair on the tensor cores: the empty b = 0 solve with
the x pair from an FP64 ``mma.sync`` product against K1, timed as CUDA-graph
replays of chained solves.

    python -m fluid_simulation_tpu_torch.tools.exp_solve_mxu [--device cuda]
        [--shape W H D] [--acc 15] [--n 50]

Port of ``tools/exp_solve_mxu.py`` (ROADMAP B23), which moved the x pair
onto the TPU's matrix unit to spare Mosaic's lane relayouts. Rows, as the
tool's, on a padded field and right-hand side drawn from a normal
distribution (seed 0), a = 1, c = 6:

- ``base``: K1, ``kernels.linsolve.rbgs_solve(0, ..., packed=False)``, the
  tool's ``pallas_rbgs_solve`` default;
- ``mxu_x``: ``kernels/linsolve_mxu.py``, the x pair from the FP64 tensor
  cores.

Their difference is printed first (bound 0: bitwise), then ms per solve
and µs per sweep of each, and the tensor-core flops of one solve: the
band's three k-steps a tile against the tool's dense product. A row's time
is JAX's slope over chains of ``c = solve(c, prev)``: the chains of n and
3n solves are each one captured CUDA graph, ``(t(3n) - t(n)) / 2n``, best
of 3 (``tools/_timing.replay_slope``). ``--device cpu`` runs the plain
versions on the host clock (a test runs it tiny).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
from fluid_simulation_tpu_torch.kernels.linsolve_mxu import (
    A, C, band_flops, rbgs_solve_mxu)
from fluid_simulation_tpu_torch.tools._timing import clock_line
from fluid_simulation_tpu_torch.tools.exp_hbm import measure


def inputs(shape, device):
    """The tool's field and right-hand side (exp_solve_mxu.py:132-134) at
    the interior (W, H, D)."""
    W, H, D = shape
    rng = np.random.default_rng(0)
    f0, g0 = (torch.tensor(rng.normal(size=(D + 2, H + 2, W + 2))
                           .astype(np.float32), device=device)
              for _ in range(2))
    return f0, g0


def solves(acc: int):
    """(name, solve(f, prev)) of the two rows."""
    return (("base", lambda f, p: rbgs_solve(0, f, p, A, C, acc,
                                             packed=False)),
            ("mxu_x", lambda f, p: rbgs_solve_mxu(f, p, A, C, acc)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions on the host "
                         "clock, no device metric")
    ap.add_argument("--shape", type=int, nargs=3, default=(128, 64, 64),
                    metavar=("W", "H", "D"), help="interior (W, H, D)")
    ap.add_argument("--acc", type=int, default=15, help="sweeps per solve")
    ap.add_argument("--n", type=int, default=50,
                    help="solves of the short chain (the long one is 3n)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_solve_mxu {W}x{H}x{D} acc={args.acc}: "
          f"{clock_line('exp_solve_mxu', device)}, n = {args.n}", flush=True)
    f0, g0 = inputs(args.shape, device)
    rows = solves(args.acc)
    base, mxu = (solve(f0, g0) for _, solve in rows)
    diff = float((base - mxu).abs().max())
    print(f"max |base - mxu_x| = {diff:.3e} "
          f"({'BIT-EQUAL' if diff == 0 else 'DIFFERS'})", flush=True)
    t = {name: measure(lambda c, s=solve: s(c, g0), f0, args.n, device)
         for name, solve in rows}
    band, dense = band_flops(f0.shape, args.acc)
    print(f"{W}x{H}x{D} acc={args.acc}: base {t['base'] * 1e3:.4f} ms/solve "
          f"({t['base'] / max(args.acc, 1) * 1e6:.2f} us/sweep), mxu_x "
          f"{t['mxu_x'] * 1e3:.4f} ms/solve "
          f"({t['mxu_x'] / max(args.acc, 1) * 1e6:.2f} us/sweep) -> "
          f"{t['base'] / t['mxu_x']:.3f}x; tensor-core flops a solve: band "
          f"{band:.4g}, dense {dense:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
