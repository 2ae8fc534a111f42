"""Launch overhead on the card: the marginal cost per iteration of
back-to-back kernel calls, eager and replayed from a CUDA graph.

    python -m fluid_simulation_tpu_torch.tools.exp_overhead [--device cuda]
        [--n 100] [--shape W H D] [--acc 15]

Port of ``tools/exp_overhead.py`` (ROADMAP B23), which timed scan bodies
of K back-to-back kernel calls inside one compiled ``jax.lax.scan``, with
no host dispatch per call. Its rows, and one more:

- (a) the tiny kernel ``o = x + 1`` on (8, 128) f32 (``kernels/probe.py``)
  chained K = 1, 4, 16 times;
- (b) the packed solve (K1, ``kernels/linsolve.rbgs_solve``: empty scene,
  b = 1, a = 1e-4, c = 1.0006, ``prev`` = the field) chained K = 1, 3
  times at ``acc``, and alone at acc 1, 5 and ``acc``, on the padded
  field of ``--shape`` (default the reference's 128x64x64);
- (c) one torch elementwise expression over the same field,
  ``c * 1.0001 + 0.0001`` (two launches);
- (d) the step's pre-advection block at ``--shape``: the chain K1 x3 + K2
  and the one cooperative ``prestep`` (``kernels/prestep.py``, B22a).

Every row has two arms. *eager*: the wrappers called back to back, each
launch paid for by the host, as the wind tunnel runs them. *graph*: the
same body captured once with ``torch.cuda.graph`` and replayed, one host
call per iteration: the counterpart of JAX's one compiled scan. A row's
cost is JAX's slope, the best of 3 of ``(t(3n) - t(n)) / 2n``, timed with
CUDA events on the card. The replay's output must equal the eager
output bit for bit; a launch that cannot be captured raises. The graphs
live in this module only: no route, wrapper or step of the package uses
one. ``LAUNCHES`` moves at capture, not at replay, so launch counts come
from the eager arm.

On the card it then prints the host split of one wrapper call
(``host_split``) for ``add_one`` on (8, 128) and for
``trilinear_gather_window`` (K9) on random backtraces at ``--shape``: the
host nanoseconds of each part of a launch, ``time.perf_counter_ns`` over
10,000 calls per part (best of 3, the empty loop's cost taken off), in
batches of 100 with a synchronise between batches outside the clock, so
that the card never holds the host back. The parts are those of
``_build.launch`` and the wrapper around it: the checks, the output
allocation, the current-device test that stands in for a device guard,
the raw current stream, the pointers as plain ints, the ctypes call and
the C launch. The ctypes call is timed through a no-op entry point of the
same signature (``csrc/probe.cu``), and the C launch is the real entry
point's time less the no-op's.

``--device cpu`` runs the eager arm on the host clock at whatever
``--shape`` is given (a test runs it tiny); it prints no device metric,
and has no graph arm and no host split.
"""

from __future__ import annotations

import argparse
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from fluid_simulation_tpu_torch.config import SimParams
from fluid_simulation_tpu_torch.kernels import _build
from fluid_simulation_tpu_torch.kernels.advect_compat import (
    trilinear_gather_window)
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
from fluid_simulation_tpu_torch.kernels.prestep import prestep
from fluid_simulation_tpu_torch.kernels.probe import add_one
from fluid_simulation_tpu_torch.kernels.project import project_empty
from fluid_simulation_tpu_torch.ops.advect import backtrace
from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs
from fluid_simulation_tpu_torch.tools._timing import (
    capture, clock_line, event_timer, host_timer, slope)

# exp_overhead.py:80-86: the solve's coefficients
SOLVE_A, SOLVE_C = 1e-4, 1.0006


@dataclass
class Row:
    """One probe row: ``body`` is one iteration, the row's calls chained
    from fixed inputs; it returns its output tensor or tensors."""
    name: str
    body: Callable[[], Any]


def _chain(fn, x, k):
    for _ in range(k):
        x = fn(x)
    return x


def _pre_advection_chain(vel, a, c, acc):
    """K1 x3 + K2: the three diffusions (prev = the component), then the
    projection of an empty scene."""
    w = [rbgs_solve(b, v, v, a, c, acc) for b, v in zip((1, 2, 3), vel)]
    return project_empty(*w, acc)


def rows(device="cuda", shape=(128, 64, 64), acc: int = 15) -> List[Row]:
    """The probe's rows, their inputs on ``device`` (``shape`` is the
    interior (W, H, D))."""
    W, H, D = shape
    pad = (D + 2, H + 2, W + 2)
    x0 = torch.zeros((8, 128), device=device)
    f0 = torch.zeros(pad, device=device) + 0.1

    def solve(f, sweeps=acc):
        return rbgs_solve(1, f, f, SOLVE_A, SOLVE_C, sweeps)

    out = [Row(f"(a) add_one xK={k}", functools.partial(_chain, add_one, x0,
                                                        k))
           for k in (1, 4, 16)]
    out += [Row(f"(b) rbgs_solve acc={acc} xK={k}",
                functools.partial(_chain, solve, f0, k)) for k in (1, 3)]
    out += [Row(f"(b) rbgs_solve acc={s}", functools.partial(solve, f0, s))
            for s in (1, 5, acc)]
    out.append(Row("(c) torch f*1.0001+0.0001",
                   lambda: f0 * 1.0001 + 0.0001))
    rng = np.random.default_rng(0)
    vel = [torch.tensor(rng.normal(size=pad).astype(np.float32),
                        device=device) for _ in range(3)]
    p = SimParams()
    a, c = diffusion_coeffs(W, H, D, p.dt, p.diff)
    out.append(Row("(d) pre-advection chain K1 x3 + K2",
                   functools.partial(_pre_advection_chain, vel, a, c, acc)))
    out.append(Row("(d) pre-advection prestep",
                   functools.partial(prestep, *vel, None, None, a, c, acc)))
    return out


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def measure(row: Row, n: int, device="cuda") -> dict:
    """The row's eager slope and, on the card, its graph slope, in seconds
    per iteration. On the card the replay's output is first held to the
    eager output, bit for bit."""
    cpu = torch.device(device).type != "cuda"
    timer = host_timer if cpu else event_timer
    result = {"name": row.name, "eager_s": slope(row.body, n, timer=timer),
              "graph_s": None}
    if cpu:
        return result
    want = _tensors(row.body())
    graph, out = capture(row.body, device)
    graph.replay()
    torch.cuda.synchronize()
    got = _tensors(out)
    if len(got) != len(want) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want)):
        raise RuntimeError(f"exp_overhead: {row.name}: the graph replay "
                           f"differs from the eager output")
    result["graph_s"] = slope(graph.replay, n, timer=timer)
    del graph, out
    return result


def format_row(r: dict) -> str:
    graph = ("graph: none on the host" if r["graph_s"] is None
             else f"graph {r['graph_s'] * 1e6:11.2f} us/iter")
    return (f"{r['name']:36s} eager {r['eager_s'] * 1e6:11.2f} us/iter   "
            f"{graph}")


@dataclass
class Launch:
    """One wrapper's launch as the host split takes it apart: the wrapper
    end to end (``call``), its C entry point and the no-op of the same
    signature, its pointer operands and the arguments after them (the
    stream comes last), its checks and its output allocation."""
    wrapper: str
    call: Callable[[], Any]
    entry: str
    noop: str
    ptrs: Tuple[torch.Tensor, ...]
    args: tuple
    checks: Callable[[], Any]
    alloc: Callable[[], Any]


def launches(device="cuda", shape=(128, 64, 64)) -> List[Launch]:
    """``add_one`` on (8, 128) and K9 at ``shape`` (W, H, D) on backtraces
    of random velocities that reach 10 and more cells (chip_smoke.py's)."""
    x = torch.zeros((8, 128), device=device)
    W, H, D = shape
    rng = np.random.default_rng(1)
    prev = torch.tensor(rng.normal(size=(D + 2, H + 2, W + 2)).astype(
        np.float32), device=device)
    vel = [torch.tensor(rng.uniform(lo, hi, (D, H, W)).astype(np.float32),
                        device=device)
           for lo, hi in ((-20.0, 40.0), (-5.0, 5.0), (-5.0, 5.0))]
    xb, yb, zb = backtrace(*vel, 0.05, W, H, D, torch.float32)
    interior = (D, H, W)

    def k9_checks():
        if prev.ndim != 3 or min(prev.shape) < 3:
            raise ValueError("trilinear_gather: bad padded shape")
        box = tuple(n - 2 for n in prev.shape)
        _build.check_operands("trilinear_gather", (prev, xb, yb, zb),
                              (None, box, box, box))

    def add1_checks():
        _build.check_operands("probe_add1", (x,))
        if not 0 < x.numel() < 2 ** 31:
            raise ValueError("probe_add1: size")

    return [
        Launch("add_one (8, 128)", lambda: add_one(x), "fst_probe_add1",
               "fst_probe_noop", (x, torch.empty_like(x)), (x.numel(),),
               add1_checks, lambda: torch.empty_like(x)),
        Launch(f"trilinear_gather {W}x{H}x{D}",
               lambda: trilinear_gather_window(prev, xb, yb, zb),
               "fst_trilinear_gather", "fst_probe_noop9",
               (prev, xb, yb, zb, torch.empty_like(xb)), interior, k9_checks,
               lambda: torch.empty_like(xb)),
    ]


def _ns_per_call(fn, n: int, batch: int = 100) -> float:
    """Host nanoseconds per call of ``fn``: the best of 3 runs of ``n``
    calls, each in batches of ``batch`` with a synchronise between batches
    outside the clock."""
    best = float("inf")
    for _ in range(3):
        total = 0
        for _ in range(n // batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(batch):
                fn()
            total += time.perf_counter_ns() - t0
        best = min(best, total / (n // batch * batch))
    return best


def host_split(launch: Launch, n: int = 10_000) -> List[tuple]:
    """``(part, ns)`` of one wrapper call on the card, each part less the
    empty loop's cost; the last rows are the sum of the parts and the whole
    call (the wrapper itself)."""
    idx, C = launch.ptrs[0].get_device(), torch._C
    ptrs = [u.data_ptr() for u in launch.ptrs]
    stream = C._cuda_getCurrentRawStream(idx)
    _build.library()
    noop, entry = _build._ENTRY[launch.noop], _build._ENTRY[launch.entry]
    parts = [
        ("checks", launch.checks),
        ("output allocation", launch.alloc),
        ("device test", lambda: idx == C._cuda_getDevice()),
        ("current stream", lambda: C._cuda_getCurrentRawStream(idx)),
        ("pointers", lambda: tuple(map(_build.ptr, launch.ptrs))),
        ("ctypes call (no-op)", lambda: noop(*ptrs, *launch.args, stream)),
        ("ctypes call + C launch",
         lambda: entry(*ptrs, *launch.args, stream)),
    ]
    empty = _ns_per_call(lambda: None, n)
    rows = [(name, _ns_per_call(fn, n) - empty) for name, fn in parts]
    # the C launch alone: the real entry point less the no-op
    rows[-1] = ("C launch (entry - no-op)", rows[-1][1] - rows[-2][1])
    rows.append(("sum of the parts", sum(r[1] for r in rows)))
    rows.append(("whole call", _ns_per_call(launch.call, n) - empty))
    torch.cuda.synchronize()
    return rows


def format_split(launch: Launch, rows) -> str:
    lines = [f"host split of {launch.wrapper} (ns per call, "
             f"_build.launch)"]
    lines += [f"  {name:26s} {ns:9.1f}" for name, ns in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the eager arm on the host "
                         "clock, no device metric")
    ap.add_argument("--n", type=int, default=100,
                    help="iterations of the short run (the long one is 3n)")
    ap.add_argument("--shape", type=int, nargs=3, default=(128, 64, 64),
                    metavar=("W", "H", "D"), help="interior of rows (b)-(d)")
    ap.add_argument("--acc", type=int, default=15,
                    help="sweeps per solve")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(f"{clock_line('exp_overhead', device)}, n = {args.n}", flush=True)
    for row in rows(device, tuple(args.shape), args.acc):
        print(format_row(measure(row, args.n, device)), flush=True)
    if device.type == "cuda":
        for launch in launches(device, tuple(args.shape)):
            print(format_split(launch, host_split(launch)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
