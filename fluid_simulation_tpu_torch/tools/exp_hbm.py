"""Streaming ceilings on the card: z-blocked streams of one (D, H, W) f32
array, with and without halo windows, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_hbm [--device cuda]
        [--shape W H D] [--n 10]

Port of ``tools/exp_hbm.py`` (ROADMAP B23). Its rows, under its names and
in its order, each ``c = row(c)`` from ``c = 0.1`` everywhere, with the
SAME array for every input, as the JAX tool passes it:

- ``copy1``: ``o = a + 1``, z-blocks of 16 planes (``kernels/hbm.py``);
- ``copy2``: ``o = a + b``;
- ``xla2``: torch's own ``c * 1.0001 + c``, the library row that stands
  for XLA's fused stream (two eager torch kernels, not a port);
- ``copy1_blk32``: ``copy1`` in z-blocks of 32;
- ``copy2h``: ``o = ((a + b) + alo[0]) + ahi[0]`` with 8-plane lo/hi
  windows on both inputs;
- ``sweepish``: ``copy2h`` with the 14-step ``acc*1.0001 + b`` chain.

A row's time is JAX's slope: the chains of n and 3n calls are each one
captured CUDA graph, and ``(t(3n) - t(n)) / 2n``, best of 3, is the time
per call (``tools/_timing.replay_slope``). Each row prints its µs and three
rates: the bytes as the JAX tool counts them (2, 3 or ``3 + 4*hb/blk``
arrays), the bytes the kernel issues (its loads and stores, the windows
counted plane by plane), and the unique bytes (each distinct input read
once, the output written once). The second read of the same array may hit
the 50 MB L2, so this tool's same-operand rows overstate the HBM rate;
``exp_hbm2``'s distinct operands give the ceiling.

``--device cpu`` runs every row's plain version once per timing on the
host clock at whatever ``--shape`` is given (a test runs it tiny); it
prints no rate and has no graph arm.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from fluid_simulation_tpu_torch.kernels.hbm import (
    HB, stream_copy, stream_copy_plain)
from fluid_simulation_tpu_torch.tools._timing import (
    clock_line, host_timer, replay_slope, slope)

BLK = 16   # the JAX tools' z-block (exp_hbm.py:32)


@dataclass
class Row:
    """One probe row: ``step`` maps the carry to the next, from ``x0``;
    ``plain`` is the same map in plain torch and ``library`` one PyTorch
    call that computes it, where there is one. Bytes per call: ``units``
    arrays as the JAX tool counts them, ``issued`` as the kernel loads and
    stores them, ``unique`` distinct."""
    name: str
    step: Callable[[torch.Tensor], torch.Tensor]
    x0: torch.Tensor
    units: float
    issued: int
    unique: int
    plain: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    library: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def window_bytes(shape, blk: int = BLK, hb: int = HB) -> int:
    """Bytes of one input's lo and hi windows over every z-block of a (D,
    H, W) f32 array: hb planes from ``kernels.hbm.window_planes``'s starts,
    clipped to D."""
    D, H, W = shape
    r, nhb = blk // hb, -(-D // hb)
    planes = 0
    for k in range(-(-D // blk)):
        for z in (hb * max(k * r - 1, 0), hb * min(k * r + r, nhb - 1)):
            planes += min(z + hb, D) - z
    return planes * H * W * 4


def stream_rows(c0, r=None) -> List[Row]:
    """The windowed stream rows common to both tools, ``c = f(c, r)``:
    with ``r`` None the same array is every input (``exp_hbm``), else ``r``
    is the second input (``exp_hbm2``)."""
    A = c0.numel() * c0.element_size()
    units_h = 3 + 4 * HB / BLK
    two = 2 if r is None else 3          # distinct arrays moved
    issued_h = 3 * A + 2 * window_bytes(c0.shape)

    def second(c):
        return c if r is None else r

    def row(name, units, issued, library=None, **kw):
        return Row(name, lambda c: stream_copy(c, second(c), blk=BLK, **kw),
                   c0, units, issued, two * A,
                   plain=lambda c: stream_copy_plain(c, second(c), blk=BLK,
                                                     **kw), library=library)

    d = "" if r is None else "d"
    return [
        row("copy2" + d, 3, 3 * A,
            library=lambda c: torch.add(c, second(c))),
        row("copy2h" + d, units_h, issued_h, halo=True),
        row("sweepish" if r is None else "arithd", units_h, issued_h,
            halo=True, chain=True),
    ]


def rows(device="cuda", shape=(256, 256, 256)) -> List[Row]:
    """The tool's rows in its order, on a (D, H, W) array of 0.1 (``shape``
    is (W, H, D))."""
    W, H, D = shape
    c0 = torch.full((D, H, W), 0.1, device=device)
    A = c0.numel() * c0.element_size()
    copy2, copy2h, sweepish = stream_rows(c0)

    def copy1(blk):
        return dict(step=lambda c: stream_copy(c, blk=blk), x0=c0, units=2,
                    issued=2 * A, unique=2 * A,
                    plain=lambda c: stream_copy_plain(c, blk=blk),
                    library=lambda c: torch.add(c, 1.0))

    return [
        Row("copy1", **copy1(BLK)),
        copy2,
        Row("xla2", lambda c: c * 1.0001 + c, c0, 3, 5 * A, 2 * A),
        Row("copy1_blk32", **copy1(32)),
        copy2h,
        sweepish,
    ]


def measure(fn, x0, n: int, device="cuda") -> float:
    """Seconds per call of ``fn`` chained from ``x0``: a graph replay's
    slope on the card, the eager slope of one call on the host clock
    elsewhere."""
    if torch.device(device).type == "cuda":
        return replay_slope(fn, x0, n, device)
    return slope(lambda: fn(x0), n, timer=host_timer)


def format_row(row: Row, sec: float, on_card: bool, plain=None,
               library=None) -> str:
    """The row's µs (and its plain version's and library call's where
    timed) and, on the card, its three rates."""
    head = f"{row.name:12s} {sec * 1e6:11.2f} us"
    for label, t in (("plain", plain), ("library", library)):
        if t is not None:
            head += f"  {label} {t * 1e6:9.2f} us"
    if not on_card:
        return head + "  (host clock; no rate)"
    jax_bytes = row.units * row.x0.numel() * row.x0.element_size()
    return (f"{head}  {jax_bytes / sec / 1e9:8.1f} GB/s JAX "
            f"({row.units:g} arrays)  {row.issued / sec / 1e9:8.1f} GB/s "
            f"issued  {row.unique / sec / 1e9:8.1f} GB/s unique")


def run(rows_, n: int, device) -> None:
    """Time and print each row, its plain version and its library call."""
    on_card = torch.device(device).type == "cuda"
    for row in rows_:
        sec, plain, library = (
            None if fn is None else measure(fn, row.x0, n, device)
            for fn in (row.step, row.plain, row.library))
        print(format_row(row, sec, on_card, plain, library), flush=True)


def parse(argv, doc):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions on the host "
                         "clock, no device metric")
    ap.add_argument("--n", type=int, default=10,
                    help="calls of the short chain (the long one is 3n)")
    ap.add_argument("--shape", type=int, nargs=3, default=(256, 256, 256),
                    metavar=("W", "H", "D"), help="interior (W, H, D)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv, __doc__)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_hbm {W}x{H}x{D}: {clock_line('exp_hbm', device)}, "
          f"n = {args.n}", flush=True)
    run(rows(device, tuple(args.shape)), args.n, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
