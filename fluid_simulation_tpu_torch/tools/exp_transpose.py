"""Transposes on the card: the transpose probe's 2-D and rank-3 forms, and
what the pass-boundary transposes of a transposing advection would cost
against K3's direct per-axis gathers, timed as CUDA-graph replays.

    python -m fluid_simulation_tpu_torch.tools.exp_transpose MODE
        [--device cuda] [--shape W H D] [--n 10]

Port of ``tools/exp_transpose.py`` (ROADMAP B23), whose TPU question was
whether Mosaic could transpose values inside a kernel; on Hopper a thread
addresses any element, so the question left is what the transposes cost.
Modes, as the tool's (``kernels/transpose.py``, ``kernels/advect_split.
lerp_pass``):

- ``probe``: the f32 2-D transpose at the tool's 8 shapes, checked exact
  against ``a.T``, timed as its round trip ``g2(f(c) + 1)`` (two kernel
  transposes and torch's add), beside the same round trip through torch's
  ``x.transpose(0, 1).contiguous()``;
- ``probe3``: ``swap01`` (Z, Y, X) -> (Y, Z, X), ``strided_row``
  ``a[:, 3, :]``, ``major_slice_T`` ``a[:, 3, :].T`` and ``store_strided``
  ``a * 2`` at (258, 8, 128), (130, 8, 128) and (258, 16, 128), checked
  exact, each timed alone per call beside its torch form, the strided
  copies with the path they take (``kernels/transpose.copy_plan``); then
  ``swap01`` and ``store_strided`` on the bytes-bound view (D + 2, H + 2,
  W) of ``--shape`` (68 MB each way at 256^3), with their rate as a share
  of the bound (3.35 TB/s) and of ``hbm.cu``'s copy2d stream;
- ``boundary``: at ``--shape`` (default 256^3), a stack of 3 padded fields
  and one velocity, every pass K3's lerp kernel with the tool's backtrace
  ``clip(i - dtW*v, 0.5, N + 0.5)``, dtW = 0.05*W, v the x velocity on
  both axes (exp_transpose.py:203-271): ``xpass``; ``ypass_T``, the y pass
  by transposes (transpose the stack and the velocity, K3 along the last
  axis, transpose back); ``ypass_alone``, K3 along the last axis of a
  pre-transposed stack; ``ypass_direct``, K3's own y pass, a strided
  gather with no transpose; and ``xpass+ypass_T``. ``ypass_T`` must equal
  ``ypass_direct`` bitwise. Boundary cost = ``ypass_T`` - ``ypass_alone``,
  and the tool's (x+y) - x - y.

A row's time is JAX's slope: the chains of n and 3n calls are each one
captured CUDA graph, ``(t(3n) - t(n)) / 2n``, best of 3
(``tools/_timing.replay_slope``). ``--device cpu`` runs the plain
versions on the host clock (a test runs it tiny); it prints no device
metric.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels.advect_split import (
    lerp_pass, lerp_pass_plain)
from fluid_simulation_tpu_torch.kernels.transpose import (
    copy_path, strided_copy, strided_copy_plain, transpose2d,
    transpose2d_plain)
from fluid_simulation_tpu_torch.tools._timing import clock_line, rate_shares
from fluid_simulation_tpu_torch.tools.exp_hbm import measure

PROBE_SHAPES = [(256, 128), (128, 256), (258, 128), (264, 128), (256, 256),
                (2048, 128), (128, 2048), (1024, 256)]   # :71-72
PROBE3_SHAPES = [(258, 8, 128), (130, 8, 128), (258, 16, 128)]   # :192
ROW = 3   # the strided row of probe3 (:144, :159, :168)
BOUND_FORMS = ("swap01", "store_strided")   # timed on the bytes-bound view


def measure_body(body, n: int, device) -> float:
    """Seconds per call of ``body()``, as ``exp_hbm.measure`` times a step
    (the carry is a dummy that ``body`` leaves alone)."""
    return measure(lambda c: (body(), c)[1], torch.zeros(1, device=device),
                   n, device)


def probe3_forms(kernel: bool):
    """(name, f, torch form) of probe3's four cases, ``f`` through the
    wrappers (``kernel``) or the plain versions."""
    tr = transpose2d if kernel else transpose2d_plain
    cp = strided_copy if kernel else strided_copy_plain
    return [
        ("swap01", lambda a: cp(a.transpose(0, 1)),
         lambda a: a.transpose(0, 1).contiguous()),
        ("strided_row", lambda a: cp(a[:, ROW, :]),
         lambda a: a[:, ROW, :].contiguous()),
        ("major_slice_T", lambda a: tr(a[:, ROW, :]),
         lambda a: a[:, ROW, :].T.contiguous()),
        ("store_strided", lambda a: cp(a, 2.0), lambda a: a * 2.0),
    ]


def probe(device, n: int) -> None:
    tr = transpose2d
    for shape in PROBE_SHAPES:
        a = torch.tensor(np.random.default_rng(0).standard_normal(
            shape, np.float32), device=device)
        exact = torch.equal(tr(a).cpu(), a.cpu().T)
        t = measure_body(lambda: tr(tr(a) + 1.0), n, device)
        lib = measure_body(
            lambda: ((a.transpose(0, 1).contiguous() + 1.0)
                     .transpose(0, 1).contiguous()), n, device)
        R, C = shape
        print(f"{str(shape):12s} exact={exact}  {t * 1e6:9.2f} us/round-trip"
              f" ({t / (2 * R * C) * 1e9:.3f} ns/elem)  torch "
              f"{lib * 1e6:9.2f} us", flush=True)


def probe3_view(name: str, a: torch.Tensor) -> torch.Tensor:
    """The view that form ``name`` hands its kernel."""
    return {"swap01": a.transpose(0, 1), "strided_row": a[:, ROW, :],
            "major_slice_T": a[:, ROW, :], "store_strided": a}[name]


def probe3_line(name, shape, a, f, lib, n, device) -> str:
    exact = torch.equal(f(a), lib(a))
    t = measure_body(lambda: f(a), n, device)
    tl = measure_body(lambda: lib(a), n, device)
    path = ("" if name == "major_slice_T" else
            f"[{copy_path(probe3_view(name, a))}]")
    line = (f"{name + path:22s} {str(shape):16s} exact={exact}  "
            f"{t * 1e6:9.2f} us/call  torch {tl * 1e6:9.2f} us")
    if torch.device(device).type == "cuda" and name in BOUND_FORMS:
        line += "  " + rate_shares(2 * a.numel() * a.element_size(), t)
    return line


def probe3(device, n: int, shape=(256, 256, 256)) -> None:
    """probe3's rows at its shapes, then the bound forms on the padded
    (D + 2, H + 2, W) view of ``shape`` (W, H, D)."""
    rng = np.random.default_rng(0)
    W, H, D = shape
    for shape3 in PROBE3_SHAPES + [(D + 2, H + 2, W)]:
        for name, f, lib in probe3_forms(kernel=True):
            if shape3 not in PROBE3_SHAPES and name not in BOUND_FORMS:
                continue
            a = torch.tensor(rng.standard_normal(shape3, np.float32),
                             device=device)
            print(probe3_line(name, shape3, a, f, lib, n, device),
                  flush=True)
            del a


def boundary_case(shape, device, seed=0):
    """The boundary rows' inputs at (W, H, D): a stack of 3 padded fields,
    the x velocity (times 0.02, as the tool) and dtW rounded to f32."""
    W, H, D = shape
    D2, H2, W2 = D + 2, H + 2, W + 2
    rng = np.random.default_rng(seed)
    stack = torch.tensor(rng.standard_normal((3, D2, H2, W2), np.float32),
                         device=device)
    vx = torch.tensor(rng.standard_normal((D2, H2, W2), np.float32) * 0.02,
                      device=device)
    return stack, vx, float(np.float32(0.05 * W))


def passes(kernel: bool):
    """The boundary rows' passes: (xpass, ypass_T, ypass_alone,
    ypass_direct), through the wrappers (``kernel``) or the plain
    versions."""
    lp = lerp_pass if kernel else lerp_pass_plain
    tr = transpose2d if kernel else transpose2d_plain

    def xpass(stack, v, dtW):
        return lp(stack, v, 2, dtW, (0, 0, 1))            # (3, D2, H2, W)

    def ypass_alone(At, vT, dtW):
        return lp(At, vT, 2, dtW, (0, 1, 1))              # (3, D2, W, H)

    def ypass_T(A, v, dtW):
        Bn, D2, H2, W = A.shape
        At = tr(A.reshape(Bn * D2, H2, W)).reshape(Bn, D2, W, H2)
        bt = ypass_alone(At, tr(v), dtW)
        H = H2 - 2
        return tr(bt.reshape(Bn * D2, W, H)).reshape(Bn, D2, H, W)

    def ypass_direct(A, v, dtW):
        return lp(A, v, 1, dtW, (0, 1, 1))                # (3, D2, H, W)

    return xpass, ypass_T, ypass_alone, ypass_direct


def boundary(device, n: int, shape) -> float:
    """Print the boundary rows; returns max |ypass_T - ypass_direct|."""
    stack, vx, dtW = boundary_case(shape, device)
    xpass, ypass_T, ypass_alone, ypass_direct = passes(kernel=True)
    A = xpass(stack, vx, dtW)
    Bn, D2, H2, W = A.shape
    At0 = transpose2d(A.reshape(Bn * D2, H2, W)).reshape(Bn, D2, W, H2)
    vT0 = transpose2d(vx)
    err = float((ypass_T(A, vx, dtW) - ypass_direct(A, vx, dtW)).abs().max())
    rows = (("xpass", lambda: xpass(stack, vx, dtW)),
            ("xpass+ypass_T", lambda: ypass_T(xpass(stack, vx, dtW), vx,
                                              dtW)),
            ("ypass_T", lambda: ypass_T(A, vx, dtW)),
            ("ypass_alone", lambda: ypass_alone(At0, vT0, dtW)),
            ("ypass_direct", lambda: ypass_direct(A, vx, dtW)))
    t = {}
    for name, body in rows:
        t[name] = measure_body(body, n, device)
        print(f"{name:24s} {t[name] * 1e3:9.4f} ms", flush=True)
    print(f"boundary cost = {(t['ypass_T'] - t['ypass_alone']) * 1e3:.4f} ms"
          f" (ypass_T - ypass_alone); the tool's (x+y) - x - y = "
          f"{(t['xpass+ypass_T'] - t['xpass'] - t['ypass_alone']) * 1e3:.4f}"
          f" ms; direct y pass {t['ypass_direct'] * 1e3:.4f} ms against "
          f"{t['ypass_T'] * 1e3:.4f} by transposes; max |ypass_T - "
          f"ypass_direct| = {err:.3g} (bound 0)", flush=True)
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("probe", "probe3", "boundary"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions on the host "
                         "clock, no device metric")
    ap.add_argument("--n", type=int, default=10,
                    help="calls of the short chain (the long one is 3n)")
    ap.add_argument("--shape", type=int, nargs=3, default=(256, 256, 256),
                    metavar=("W", "H", "D"),
                    help="boundary and probe3's bytes-bound view: the "
                         "interior (W, H, D)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(f"exp_transpose {args.mode}: "
          f"{clock_line('exp_transpose', device)}, n = {args.n}", flush=True)
    if args.mode == "probe":
        probe(device, args.n)
    elif args.mode == "probe3":
        probe3(device, args.n, tuple(args.shape))
    else:
        boundary(device, args.n, tuple(args.shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
