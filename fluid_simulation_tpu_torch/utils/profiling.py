"""Where a step's time goes on the card: host wall clock, device busy and idle
share, device time by kernel and by phase of the step, from
``torch.profiler``; and the step's spans.

    python -m fluid_simulation_tpu_torch.utils.profiling [--steps N] [--out FILE]
        [--cells LABEL ...] [--wall-only] [--shards N] [--trace-out FILE]

profiles the cells on one CUDA device (split and compat at 128x64x64, split
at 128x64x64 with the bench's sphere and with no-slip walls and vorticity,
the split step on the plain torch path, fast at 128x64x64, compat and fast
there with ``advect_window=1`` (the trilinear kernel), and the bench's big
grids in split mode, 256x128x128, 256^3 and 512x256x256, each empty and
with its sphere), prints
one summary line, the top device operations and the phases of the step
per cell, and writes the numbers as JSON to ``--out``. ``--cells`` keeps
only the cells with those labels; ``--wall-only`` times the host wall per
step and skips the profiler, for repeated runs that compare two trees.
``--shards N`` runs the cells (by default split 256^3 and compat 128x64x64)
as ``ShardedWindTunnel``s over N z-slabs with every rank on the one card,
labelled ``<cell> / N slabs``. ``--trace-out FILE`` writes a Chrome trace
of ``--steps`` steps of the one cell ``--cells`` names (``trace_ctx``). A
CPU tensor has no device metric, so the measurement refuses to run without
a card.

The phases are the spans the step opens (``span``): ``fst.step`` around
each ``simulation_step``, and inside it ``fst.inlets``, ``fst.diffuse``,
``fst.project`` (twice), ``fst.advect``, ``fst.confine`` (with vorticity),
``fst.advect_density``, ``fst.stats``, and ``fst.bounds`` in whichever of
them pads; ``WindTunnel.__init__`` opens ``fst.setup`` around
``fst.setup.masks`` and ``fst.setup.state``.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

from fluid_simulation_tpu_torch.config import SimParams
from fluid_simulation_tpu_torch.scene.primitives import (
    add_sphere, empty_obstacles)

# runtime calls that block the host on the card, and calls that enqueue
# device work (``windbench``'s readers count the same)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")
ENQUEUE = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host-only span ``name`` in the running ``torch.profiler`` trace,
    for ``with``: a RecordFunction that is not a user annotation, so the
    profiler adds no device row for it, on the clock of the device's rows.
    With no profiler recording it costs one flag check."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def timed_span(name: str, into: Dict[str, float]):
    """``span(name)``, its host seconds always kept in ``into[name]``: for
    work that runs once, such as a tunnel's set-up."""
    t0 = time.perf_counter()
    with span(name):
        yield
    into[name] = time.perf_counter() - t0


@contextlib.contextmanager
def trace_ctx(path: Optional[str]):
    """``with trace_ctx('step.json'): ...`` records the block with
    ``torch.profiler`` (host ops, the ``fst.*`` spans and, with a card, the
    device's operations, on one clock) and writes it to ``path`` as a
    Chrome trace; a no-op when ``path`` is falsy."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: the time during
    which at least one device operation ran (overlaps count once)."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def step_breakdown(wt, steps: int = 20, warmup: int = 5,
                   top: int = 12) -> Dict:
    """Profile ``steps`` calls of ``wt.step()`` on a CUDA WindTunnel.

    ``wall_ms`` is from ``host_ms``, taken before the profiler attaches
    (an attached profiler slows every launch); ``busy_ms`` is the union of
    the device operations' intervals per step under the profiler, and
    ``idle`` is ``1 - busy_ms / wall_ms``. ``top`` lists (name, launches
    per step, device ms per step); ``phases`` is ``phase_table``'s, per
    step."""
    wall = host_ms(wt, steps, warmup)
    prof = device_profile(wt.step, steps, top)
    return dict(wall_ms=wall, busy_ms=prof["busy_ms"],
                idle=1.0 - prof["busy_ms"] / wall,
                device_ops=prof["device_ops"], top=prof["top"],
                phases=prof["phases"])


def device_profile(fn, calls: int, top: int = 12) -> Dict:
    """Profile ``calls`` calls of ``fn`` (already warm) on the card:
    ``busy_ms`` is the union of the device operations' intervals per call,
    ``device_ops`` the device operations per call, ``top`` lists (name,
    launches per call, device ms per call), ``phases`` the ``fst.*`` spans
    by ``phase_table``, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end, e.id)
        (dev if e.device_type == DeviceType.CUDA else host).append(row)
    by_name: Dict[str, list] = {}
    for name, s, e, _ in dev:
        n_us = by_name.setdefault(name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e - s
    busy_ms = busy_us((s, e) for _, s, e, _ in dev) / calls / 1e3
    rows = sorted(((name, n / calls, us / calls / 1e3)
                   for name, (n, us) in by_name.items()),
                  key=lambda r: -r[2])
    return dict(busy_ms=busy_ms, device_ops=len(dev) / calls,
                top=rows[:top], phases=phase_table(host, dev, calls))


def _innermost(spans: List[Tuple[float, float]]):
    """For ``(start, end)`` spans, sorted by start and nested (each either
    inside or apart from another, as the spans of one thread are): the
    index of each span's parent (-1 for none), and a function from a time
    to the index of the innermost span open then (-1 for none)."""
    starts = [s for s, _ in spans]
    parent, stack = [], []
    for i, (s, e) in enumerate(spans):
        while stack and spans[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def at(t: float) -> int:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        return i
    return parent, at


def phase_table(host, dev, calls: int) -> Dict[str, Dict[str, float]]:
    """The ``fst.*`` spans of a profile, by name, per call of the profiled
    function. ``host`` and ``dev`` rows are (name, start us, end us,
    correlation id) of host and device events. Each runtime call and each
    device op belongs to the innermost span open when the call that
    launched it started (matched by correlation id):

    - ``calls``: spans of the name;
    - ``self_ms``: their host time less their child spans' and the
      blocking calls' (``BLOCKING``) directly in them;
    - ``blocked_ms``: those blocking calls' time;
    - ``launches``: calls that enqueue device work (``ENQUEUE``);
    - ``device_ms``: device time of the ops those calls launched.

    The row ``(no span)`` holds the device ms of ops launched outside every
    span, and ``(not matched)`` of ops whose launching call is not in the
    profile: with them the rows' ``device_ms`` add up to the device ops'
    summed time."""
    spans = sorted((s, e, n) for n, s, e, _ in host
                   if n.startswith("fst."))
    parent, at = _innermost([(s, e) for s, e, _ in spans])
    names = [n for _, _, n in spans]
    keys = ("calls", "self_ms", "blocked_ms", "launches", "device_ms")
    out = {n: dict.fromkeys(keys, 0.0) for n in names}
    outside = {"(no span)": dict.fromkeys(keys, 0.0),
               "(not matched)": dict.fromkeys(keys, 0.0)}
    for i, (s, e, n) in enumerate(spans):
        out[n]["calls"] += 1
        out[n]["self_ms"] += e - s
        if parent[i] >= 0:
            out[names[parent[i]]]["self_ms"] -= e - s
    launched = {}
    for n, s, e, cid in host:
        if not n.startswith("cu"):     # a CUDA runtime or driver call
            continue
        i = at(s)
        row = out[names[i]] if i >= 0 else outside["(no span)"]
        launched[cid] = row
        if n in BLOCKING:
            row["blocked_ms"] += e - s
            if i >= 0:
                row["self_ms"] -= e - s
        elif n in ENQUEUE:
            row["launches"] += 1
    for _, s, e, cid in dev:
        launched.get(cid, outside["(not matched)"])["device_ms"] += e - s
    out.update((k, v) for k, v in outside.items() if v["device_ms"])
    for row in out.values():
        for k in keys:
            row[k] /= calls if k in ("calls", "launches") else calls * 1e3
    return out


def host_ms(wt, steps: int, warmup: int = 5) -> float:
    """Host wall ms per step of ``steps`` calls of ``wt.step()`` after
    ``warmup`` steps, ending in a synchronise."""
    if wt.device.type != "cuda":
        raise RuntimeError(f"profiling needs a CUDA WindTunnel, got "
                           f"{wt.device}: a CPU run gives no device metric")
    wt.simulate(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        wt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def flagship_sphere() -> np.ndarray:
    """The JAX bench's ``obstacle_sphere`` scene (bench.py:224-226): a
    sphere of radius 10 at (40, 32, 32) in the 128x64x64 tunnel."""
    return add_sphere(empty_obstacles(128, 64, 64), cx=40, cy=32, cz=32,
                      radius=10)


# the JAX bench's big grids (W, H, D) and their spheres (bench.py:227-263)
BIG_SPHERES = {(256, 128, 128): dict(cx=85, cy=64, cz=64, radius=20),
               (256, 256, 256): dict(cx=48, cy=128, cz=128, radius=40),
               (512, 256, 256): dict(cx=48, cy=128, cz=128, radius=40)}


def big_sphere(width: int, height: int, depth: int) -> np.ndarray:
    """The JAX bench's sphere scene of one of its big grids."""
    return add_sphere(empty_obstacles(width, height, depth),
                      **BIG_SPHERES[(width, height, depth)])


def big_cells() -> Dict[str, Tuple[SimParams, Optional[np.ndarray]]]:
    """The bench's six big configs in split mode, each empty and with its
    sphere: the streamed route (``kernels/linsolve_stream.py``). Building
    the spheres takes ~1 GB of host memory at 512x256x256."""
    split = SimParams(div_stats=False, step_stats=False, mode="split")
    out = {}
    for (w, h, d) in BIG_SPHERES:
        p = split.replace(width=w, height=h, depth=d)
        out[f"split {w}x{h}x{d}"] = (p, None)
        out[f"split {w}x{h}x{d} sphere"] = (p, big_sphere(w, h, d))
    return out


def cells() -> Dict[str, Tuple[SimParams, Optional[np.ndarray]]]:
    """The cells on the kernel path, as chip_smoke.py times them: label ->
    (params, padded obstacle field or None for the empty tunnel)."""
    base = SimParams(div_stats=False, step_stats=False)
    split = base.replace(mode="split")
    return {
        "split 128x64x64": (split, None),
        "compat 128x64x64": (base, None),
        "split 256x128x128": (split.replace(width=256, height=128,
                                            depth=128), None),
        "split 128x64x64 sphere": (split, flagship_sphere()),
        "split 128x64x64 noslip+vorticity": (
            split.replace(wall_mode="noslip", vorticity=5.0), None),
    }


def make_tunnel(p: SimParams, obs, shards: int = 0, device="cuda"):
    """A ``WindTunnel`` on ``device``, or with ``shards`` a
    ``ShardedWindTunnel`` over that many z-slabs, every rank on
    ``device``."""
    if shards:
        from fluid_simulation_tpu_torch.parallel import ShardedWindTunnel
        return ShardedWindTunnel(p, obstacles=obs, devices=[device] * shards)
    from fluid_simulation_tpu_torch import WindTunnel
    return WindTunnel(p, obstacles=obs, device=device)


def shard_cells(todo, shards: int):
    """``todo``'s cells relabelled ``<cell> / N slabs`` for a sharded run;
    a cell whose depth ``shards`` does not divide is refused."""
    bad = [k for k, (p, _) in todo.items() if p.depth % shards]
    if bad:
        raise SystemExit(f"profiling: depth of {bad} not divisible by "
                         f"{shards} slabs")
    return {f"{k} / {shards} slabs": v for k, v in todo.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", help="write the breakdowns here as JSON")
    ap.add_argument("--cells", nargs="+", metavar="LABEL",
                    help="only these cells, by the labels printed")
    ap.add_argument("--wall-only", action="store_true",
                    help="host wall time per step only, without the "
                         "profiler")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="run the cells sharded over N z-slabs, every rank "
                         "on the one card")
    ap.add_argument("--trace-out", metavar="FILE",
                    help="write a Chrome trace of --steps steps of the one "
                         "cell --cells names")
    args = ap.parse_args(argv)
    if args.trace_out and len(args.cells or ()) != 1:
        raise SystemExit("profiling: --trace-out needs one cell in --cells")
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    out = {"card": card, "steps": args.steps, "cells": {}}
    todo = cells()
    split, _ = todo["split 128x64x64"]
    todo["split 128x64x64 plain"] = (split.replace(use_pallas=False), None)
    compat, _ = todo["compat 128x64x64"]
    todo["fast 128x64x64"] = (compat.replace(mode="fast"), None)
    for mode in ("compat", "fast"):
        todo[f"{mode} 128x64x64 window"] = (
            compat.replace(mode=mode, advect_window=1), None)
    todo.update(big_cells())
    cells_asked = args.cells
    if args.shards and not cells_asked:
        cells_asked = ["split 256x256x256", "compat 128x64x64"]
    if cells_asked:
        unknown = set(cells_asked) - set(todo)
        if unknown:
            raise SystemExit(f"profiling: no cell {sorted(unknown)}; the "
                             f"cells are {list(todo)}")
        todo = {k: todo[k] for k in cells_asked}
    if args.shards:
        todo = shard_cells(todo, args.shards)
    for label, (p, obs) in todo.items():
        wt = make_tunnel(p, obs, args.shards)
        if args.wall_only:
            wall = host_ms(wt, args.steps)
            out["cells"][label] = {"wall_ms": wall}
            print(f"== {label}: wall {wall:.4f} ms/step", flush=True)
            continue
        r = step_breakdown(wt, steps=args.steps)
        out["cells"][label] = r
        print(f"== {label}: wall {r['wall_ms']:.4f} ms/step, device busy "
              f"{r['busy_ms']:.4f} ms/step, idle {100 * r['idle']:.1f} %, "
              f"{r['device_ops']:.1f} device ops/step", flush=True)
        for name, n, ms in r["top"]:
            print(f"   {ms:9.4f} ms/step {n:7.1f}/step  {name[:88]}",
                  flush=True)
        print(f"   {'phase':22s} {'calls':>6s} {'self ms':>9s} "
              f"{'blocked ms':>10s} {'launches':>8s} {'device ms':>9s}",
              flush=True)
        for name, ph in r["phases"].items():
            print(f"   {name:22s} {ph['calls']:6.1f} {ph['self_ms']:9.4f} "
                  f"{ph['blocked_ms']:10.4f} {ph['launches']:8.1f} "
                  f"{ph['device_ms']:9.4f}", flush=True)
        if args.trace_out:
            with trace_ctx(args.trace_out):
                for _ in range(args.steps):
                    wt.step()
            print(f"   trace: {args.trace_out}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
