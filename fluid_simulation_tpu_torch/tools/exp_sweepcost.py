"""Where the streamed pass kernel's time goes: the pass with one mechanism
removed at a time, at nsw 1 and 2, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_sweepcost
        [--device cuda] [--shape W H D] [--n 10]

Port of ``tools/exp_sweepcost.py`` (ROADMAP B23). Its rows, under its names
and in its order (``kernels/sweepcost.py`` says what each removes), each
``c = row(c, r)`` from ``c = 0.1`` everywhere with ``r = 1.5c + 0.25``
made once: ``full``, ``nosel``, ``noiota``, ``noroll``, ``nozn`` and
``arith``, at nsw 1 (the JAX probe's 1-sweep kernel) and nsw 2 (the pass
the big-grid route runs), empty scene, b = 1, reference walls, a = 1e-4,
c = 1.0006 (``exp_sweepcost.py:42``), and after each nsw the production
pass itself (``rbgs_pass``, through ``kernels/linsolve_stream.sweep_pass``:
the same template as ``full``, built in another file). Each row prints
its µs per pass and its share of ``full`` at the same nsw. Then
``copy2hd``, ``exp_hbm2``'s distinct-operand windowed stream, and
``full``'s ratio to it: how far the pass is from streaming its bytes.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    KERNEL_NSW, sweep_pass)
from fluid_simulation_tpu_torch.kernels.sweepcost import (
    VARIANTS, sweep_pass_variant, sweep_pass_variant_plain)
from fluid_simulation_tpu_torch.tools import exp_hbm, exp_hbm2
from fluid_simulation_tpu_torch.tools._timing import clock_line

SC_B, SC_A, SC_C = exp_hbm2.PASS_B, exp_hbm2.PASS_A, exp_hbm2.PASS_C


def rows(device="cuda", shape=(256, 256, 256)):
    """``(c0, variants, copy2hd)``: the carry, then ``(name, nsw, kernel,
    plain)`` of every variant and of the production pass at each nsw, each
    a map of the carry, then ``exp_hbm2``'s ``copy2hd`` row (``shape`` is
    (W, H, D))."""
    W, H, D = shape
    c0 = torch.full((D, H, W), 0.1, device=device)
    r = c0 * 1.5 + 0.25

    def kernel(v, nsw):
        if v == "rbgs_pass":
            return lambda c: sweep_pass(c, r, None, SC_B, SC_A, SC_C, nsw)
        return lambda c: sweep_pass_variant(c, r, v, nsw, SC_B, SC_A, SC_C)

    def plain(v, nsw):
        v = "full" if v == "rbgs_pass" else v
        return lambda c: sweep_pass_variant_plain(c, r, v, nsw, SC_B, SC_A,
                                                  SC_C)

    variants = [(f"{v} nsw={nsw}", nsw, kernel(v, nsw), plain(v, nsw))
                for nsw in KERNEL_NSW for v in VARIANTS + ("rbgs_pass",)]
    return c0, variants, exp_hbm.stream_rows(c0, r)[1]


def main(argv=None) -> int:
    args = exp_hbm.parse(argv, __doc__)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_sweepcost {W}x{H}x{D}: "
          f"{clock_line('exp_sweepcost', device)}, n = {args.n}", flush=True)
    c0, variants, copy2hd = rows(device, tuple(args.shape))
    full = {}
    for name, nsw, kernel, plain in variants:
        sec = exp_hbm.measure(kernel, c0, args.n, device)
        full.setdefault(nsw, sec)            # VARIANTS[0] is full
        psec = exp_hbm.measure(plain, c0, args.n, device)
        print(f"{name:15s} {sec * 1e6:11.2f} us/pass  "
              f"{sec / full[nsw]:6.3f} of full  plain {psec * 1e6:11.2f} us",
              flush=True)
    ceiling = exp_hbm.measure(copy2hd.step, c0, args.n, device)
    print(exp_hbm.format_row(copy2hd, ceiling, device.type == "cuda"),
          flush=True)
    for nsw, sec in full.items():
        print(f"full nsw={nsw} / copy2hd: {sec / ceiling:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
