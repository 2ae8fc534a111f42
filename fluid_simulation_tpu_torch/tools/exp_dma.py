"""Per-thread loads against TMA on the card: the DMA-issue probe's windowed
streams of one (D, H, W) array, f32 and bf16, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_dma [--device cuda]
        [--shape W H D] [--blks 8 16] [--n 10]

Port of ``tools/exp_dma.py`` (ROADMAP B23). On the TPU it asked whether
the streaming kernels' time follows DMA issues or bytes; on Hopper the
question is what a TMA box costs against plain per-thread loads for the
same windows. Rows, in the tool's order (dtype, then blk, then form), each
``c = row(c, r)`` from ``c = 0.1`` everywhere with the second operand
``r = c * 1.5 + 0.25`` (the tool's distinct operands), through
``kernels/dma.py``:

- ``copy2[ldg]``, ``copy2[tma]``: ``o = a + b``, one work item a block;
  the items do not depend on blk, so the rows at each blk time one launch;
- ``copy2h[ldg]``, ``copy2h[tma]``: ``o = (a + b) + (alo[0] + ahi[0])``
  with the lo/mid/hi windows (hb = 2) on both operands;
- ``manual2[tma]``: ``o = a + b`` from one merged (blk + 2hb)-plane box
  per operand, double-buffered (only where D % blk == 0, as in the tool).

A row's time is JAX's slope: the chains of n and 3n calls are each one
captured CUDA graph, ``(t(3n) - t(n)) / 2n``, best of 3
(``tools/_timing.replay_slope``). Each row prints its µs, its plain
version's and (copy2) ``torch.add``'s, the rate by the tool's byte units
(3 arrays, or ``3 + 4*hb/blk`` with the windows) as a share of the bound
and of ``hbm.cu``'s copy2d stream, and its issues per z-block: the
tool's DMA issues (3, 7, 3 with the output's) beside this kernel's, TMA
boxes per tile or 16-byte loads per thread (copy2's per plane, whatever
blk is).

``--device cpu`` runs every row's plain version on the host clock at
whatever ``--shape`` is given (a test runs it tiny); it prints no rate.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from fluid_simulation_tpu_torch.kernels.dma import (
    FORMS, HB, LDG_PLANES, check_form, dma_stream, dma_stream_plain,
    loaders)
from fluid_simulation_tpu_torch.tools._timing import clock_line, rate_shares
from fluid_simulation_tpu_torch.tools.exp_hbm import measure

DTYPES = ((torch.float32, ""), (torch.bfloat16, "_bf16"))
JAX_ISSUES = {"copy2": 3, "copy2h": 7, "manual2": 3}   # exp_dma.py:14-19


@dataclass
class Row:
    """One probe row: ``step`` maps the carry to the next, from ``x0``;
    ``plain`` the same map in plain torch and ``library`` one PyTorch call
    that computes it, where there is one. ``units``: arrays moved as the
    tool counts them; ``issues``: this kernel's issues per z-block."""
    name: str
    blk: int
    step: Callable[[torch.Tensor], torch.Tensor]
    x0: torch.Tensor
    units: float
    issues: str
    plain: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    library: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def second_operand(c0: torch.Tensor) -> torch.Tensor:
    """The tool's second operand, ``r = c * 1.5 + 0.25`` (exp_dma.py:55)."""
    return c0 * 1.5 + 0.25


def issues(form: str, loader: str, blk: int, hb: int = HB) -> str:
    """This kernel's issues per z-block of a tile: copy2h's TMA kernel one
    box per window per operand, manual2's one merged box per operand, and
    the ldg loader's 16-byte loads per thread. copy2's kernels issue per
    plane whatever blk is: one TMA box per operand, or two loads a thread
    with ``LDG_PLANES`` planes of both operands at once."""
    if form == "copy2":
        return ("2 boxes/plane, any blk" if loader == "tma" else
                f"2 loads/thread/plane, {2 * LDG_PLANES} in flight, any blk")
    if loader == "tma":
        return f"{ {'copy2h': 6, 'manual2': 2}[form]} boxes"
    return f"{2 * blk + 4 * hb} loads/thread"


def rows(device="cuda", shape=(256, 256, 256), blks=(8, 16)) -> List[Row]:
    """The tool's rows in its order on a (D, H, W) array of 0.1 (``shape``
    is (W, H, D)); forms the kernel refuses at this shape are left out."""
    W, H, D = shape
    out = []
    for dtype, tag in DTYPES:
        c0 = torch.full((D, H, W), 0.1, dtype=dtype, device=device)
        r = second_operand(c0)
        for blk in blks:
            for form in FORMS:
                for loader in loaders(form):
                    try:
                        check_form(c0, form, blk, loader)
                    except ValueError:
                        continue
                    kw = dict(b=r, form=form, blk=blk, loader=loader)
                    units = 3 + (4 * HB / blk if form != "copy2" else 0)
                    out.append(Row(
                        f"{form}{tag}[{loader}]", blk,
                        lambda c, kw=kw: dma_stream(c, **kw), c0, units,
                        issues(form, loader, blk),
                        plain=lambda c, kw=kw: dma_stream_plain(c, **kw),
                        library=(lambda c, r=r: torch.add(c, r))
                        if form == "copy2" else None))
    return out


def format_row(row: Row, sec: float, on_card: bool, plain=None,
               library=None) -> str:
    head = f"{row.name:18s} blk={row.blk:<3d} {sec * 1e6:11.2f} us"
    for label, t in (("plain", plain), ("library", library)):
        if t is not None:
            head += f"  {label} {t * 1e6:9.2f} us"
    form = row.name.split("[")[0].removesuffix("_bf16")
    head += (f"  issues/z-block: JAX {JAX_ISSUES[form]}, here "
             f"{row.issues}")
    if not on_card:
        return head + "  (host clock; no rate)"
    moved = row.units * row.x0.numel() * row.x0.element_size()
    return f"{head}  {rate_shares(moved, sec)} ({row.units:g} arrays)"


def run(rows_, n: int, device) -> None:
    """Time and print each row, its plain version and its library call."""
    on_card = torch.device(device).type == "cuda"
    for row in rows_:
        sec, plain, library = (
            None if fn is None else measure(fn, row.x0, n, device)
            for fn in (row.step, row.plain, row.library))
        print(format_row(row, sec, on_card, plain, library), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions on the host "
                         "clock, no device metric")
    ap.add_argument("--n", type=int, default=10,
                    help="calls of the short chain (the long one is 3n)")
    ap.add_argument("--shape", type=int, nargs=3, default=(256, 256, 256),
                    metavar=("W", "H", "D"), help="the array's (W, H, D)")
    ap.add_argument("--blks", type=int, nargs="+", default=(8, 16),
                    help="z-block depths (the tool's default 8 16)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_dma {W}x{H}x{D}: {clock_line('exp_dma', device)}, n = "
          f"{args.n}", flush=True)
    run(rows(device, tuple(args.shape), tuple(args.blks)), args.n, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
