"""One run of one cell: set-up, the measured window, the traced segment, the
per-layer readers and the check against the plain reference.

The window drives the system under test in a closed loop of frames: a
frame is ``frame_steps`` steps, then the frame's stats (density sum and max
divergence of each step) read back to the host, as a user of the tunnel
watches a live run. The window ends with the first frame that would start
after ``seconds``.

The check compares what the window produced with ``reference/step.py``:

- ``start_gap``: the first ``WARMUP_STEPS`` steps from the seeded state
  (set-up runs them, and they warm every shape), against the reference
  following the same steps on its own from the same state;
- ``step_gap``: ``N_CAPTURES`` steps of the window, at points drawn from
  the seed, each against one reference step from the program's own input
  to that step (the reference cannot follow thousands of steps inside the
  run's time, so it follows the program's state there);
- ``stats_gap``: the density sum and max divergence of all those steps
  against the reference's.

A field's gap is max |program - reference| over the padded field divided by
max |reference|; a number is the largest over the fields and steps it
covers. Each number has its limit in the cell's file (``limits``).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from windbench import traffic
from windbench.reference import step as ref

ROOT = traffic.ROOT
WARMUP_STEPS = 2
N_CAPTURES = 2
PROFILE_MIN_STEPS = 20
FORBIDDEN = ("jax", "jaxlib", "flax", "fluid_simulation_tpu")
CHECKS = ("start_gap", "step_gap", "stats_gap")
SPANS = ("windbench.step", "windbench.readback")
ENTRY_SPAN = "windbench.entry."


def benchmark() -> dict:
    with open(ROOT.parent / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_metrics(spec: dict, cell: str):
    """(end-to-end names, per-layer names) that ``cell`` reports."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m["name"] for m in spec["end_to_end"] if mine(m)],
            [m["name"] for m in spec["per_layer"] if mine(m)])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def process_age_s(fallback_start: float) -> float:
    """Seconds since this process started (``/proc``), or since
    ``fallback_start`` (a ``perf_counter`` reading) where that is
    unreadable."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_start


class PortSystem:
    """The system under test: one ``fluid_simulation_tpu_torch.WindTunnel``
    built from the configuration and the benchmark's obstacle field."""

    def __init__(self, config: dict, obstacles: np.ndarray, device):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.models.windtunnel import FluidState
        self._state_cls = FluidState
        params = {k: config[k] for k in SimParams.__dataclass_fields__}
        self.wt = WindTunnel(SimParams(**params), obstacles=obstacles,
                             device=device)

    def set_state(self, fields):
        self.wt.state = self._state_cls(*fields)

    def state(self):
        return tuple(self.wt.state)

    def step(self):
        st = self.wt.step()
        return st.density_sum, st.max_divergence


class ReferenceSystem:
    """The plain reference put in the program's place, computing in
    ``dtype``: the low-precision control (bfloat16) of a float32 cell."""

    def __init__(self, config: dict, obstacles: np.ndarray, device,
                 dtype=torch.bfloat16):
        self.dtype = dtype
        self.p = ref.params_of(config)
        self.m = ref.build_masks(obstacles, dtype, device)
        self.fields = None

    def set_state(self, fields):
        self.fields = tuple(f.to(self.dtype) for f in fields)

    def state(self):
        return tuple(f.to(torch.float32) for f in self.fields)

    def step(self):
        self.fields, stats = ref.step(self.fields, self.m, self.p)
        return stats


class Cell:
    """A cell's data and its system, built once (``scene_setup_s`` spans
    building the obstacle field and constructing the system)."""

    def __init__(self, name: str, device, system=PortSystem,
                 workload: Optional[dict] = None,
                 config: Optional[dict] = None):
        self.name = name
        self.workload = workload or traffic.load_json("workloads", name)
        self.config = config or traffic.load_json(
            "configs", self.workload["config"])
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.obstacles = traffic.scene(self.workload["scene"], self.config)
        self.system = system(self.config, self.obstacles, self.device)
        self.scene_setup_s = time.perf_counter() - t0


class Captures:
    """Host copies of the states and stats the check reads: the outputs of
    the warm-up steps (``start``, copied in set-up), and the input and
    output of each captured window step (``buf``, page-locked on the card's
    host, so a capture in the window is an asynchronous copy in stream
    order)."""

    def __init__(self, shape, device):
        self.start = []
        self.buf = torch.empty((2 * N_CAPTURES, 4) + tuple(shape),
                               dtype=torch.float32,
                               pin_memory=device.type == "cuda")
        self.stats = {}
        self.taken = 0

    def save(self, slot: int, fields):
        for dst, src in zip(self.buf[slot], fields):
            dst.copy_(src, non_blocking=True)

    @staticmethod
    def window(i):
        """(input slot, output slot) of window capture ``i``."""
        return 2 * i, 2 * i + 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frames(system, frame_steps, seconds, device, caps=None, points=()):
    """The closed loop of frames for ``seconds``. Returns (frame ms list,
    failed frames, steps, wall s). With ``caps``, the first step of the
    first frame after each point (a share of ``seconds``) is captured; where
    a frame outlasts the window's end before the last point, one more frame
    takes it."""
    pending = list(points)
    frame_ms, failed, steps = [], 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline and not (caps is not None and pending):
            break
        cap = None
        if caps is not None and pending and \
                t0 - t_start >= pending[0] * seconds:
            pending.pop(0)
            cap = caps.window(caps.taken)
            caps.save(cap[0], system.state())
        outs = []
        for i in range(frame_steps):
            outs.extend(system.step())
            if cap is not None and i == 0:
                caps.save(cap[1], system.state())
        vals = torch.stack(outs).cpu()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        steps += frame_steps
        if not bool(torch.isfinite(vals).all()):
            failed += 1
        if cap is not None:
            caps.stats[cap[1]] = vals[:2].clone()
            caps.taken += 1
    _sync(device)
    return frame_ms, failed, steps, time.perf_counter() - t_start


def warm_up(cell: Cell, seed: int, caps: Captures):
    """Set the seeded state and run the first steps, captured: they build
    and warm every kernel and shape the window uses."""
    cell.system.set_state(traffic.initial_state(
        cell.obstacles, cell.workload["init"], seed, cell.device))
    for _ in range(WARMUP_STEPS):
        stats = cell.system.step()
        caps.start.append(([f.cpu() for f in cell.system.state()],
                           torch.stack(stats).cpu()))
    _sync(cell.device)


def profile(cell: Cell, n_frames: int, readers=None):
    """``n_frames`` frames under ``torch.profiler``, each step and readback
    in a span of the benchmark's own, and each call of an entry point that
    a reader of ``readers`` (name: module) names in ``ENTRIES`` in a span
    of its own. Returns device ops as (name, start us, end us), host ops
    likewise, each entry call as (reader, device us of the kernels launched
    inside it, bytes the reader counts for it), the steps and the wall
    seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile as tprofile,
                                record_function)
    steps = cell.workload["frame_steps"]
    with entry_spans(readers or {}) as calls, \
            tprofile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            outs = []
            for _ in range(steps):
                with record_function(SPANS[0]):
                    outs.extend(cell.system.step())
            with record_function(SPANS[1]):
                torch.stack(outs).cpu()
        _sync(cell.device)
        wall = time.perf_counter() - t0
    dev, host, spans, launches, ops = [], [], [], {}, []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(row)
            if e.name.startswith(ENTRY_SPAN):
                spans.append(row)
            elif e.name.startswith("cu"):   # a CUDA runtime or driver call
                launches[e.id] = row[1]
        elif not e.name.startswith("windbench."):   # the spans' device rows
            dev.append(row)
            ops.append((e.id, row[1], row[2]))
    spans.sort(key=lambda r: r[1])
    entry_us = {}
    for (name, _, _), us in zip(spans, launched_us(
            [r[1:] for r in spans], launches, ops)):
        entry_us.setdefault(name[len(ENTRY_SPAN):], []).append(us)
    # a reader's spans in the order they started, its calls in the order
    # they ended: the same order, as no entry point calls another
    entries = [(name, entry_us[name].pop(0), nbytes)
               for name, nbytes in calls]
    return dict(device=dev, host=host, entries=entries,
                steps=n_frames * steps, window_s=wall)


def launched_us(spans, launches, ops) -> List[float]:
    """Device us of the ops launched inside each host span. ``spans``:
    (start, end), disjoint, in order; ``launches``: correlation id of each
    runtime call that launched a device op -> the call's host start;
    ``ops``: (correlation id, start, end) of each device op."""
    starts = [s for s, _ in spans]
    out = [0.0] * len(spans)
    for cid, s, e in ops:
        t = launches.get(cid)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out[i] += e - s
    return out


@contextlib.contextmanager
def entry_spans(readers):
    """For the traced segment, each entry point ``"module:function"`` that a
    reader of ``readers`` (name: module) names in ``ENTRIES`` is replaced,
    in every loaded module of its package that holds it, by a wrapper that
    runs the call in the span ``windbench.entry.<reader>`` and appends
    (reader, the reader's ``call_bytes(function, args, kwargs)``) to the
    list it yields."""
    from torch.profiler import record_function
    calls, undo = [], []

    def wrap(fn, name, count):
        def wrapped(*args, **kwargs):
            with record_function(ENTRY_SPAN + name):
                out = fn(*args, **kwargs)
            calls.append((name, count(args, kwargs)))
            return out
        return wrapped

    for name, mod in readers.items():
        for entry in getattr(mod, "ENTRIES", ()):
            modname, fname = entry.split(":")
            fn = getattr(importlib.import_module(modname), fname)
            wrapped = wrap(fn, name, functools.partial(mod.call_bytes,
                                                       fname))
            top = modname.split(".")[0]
            for holder in list(sys.modules.values()):
                if getattr(holder, "__name__", "").split(".")[0] != top:
                    continue
                for attr, value in list(vars(holder).items()):
                    if value is fn:
                        setattr(holder, attr, wrapped)
                        undo.append((holder, attr, fn))
    try:
        yield calls
    finally:
        for holder, attr, fn in reversed(undo):
            setattr(holder, attr, fn)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
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


def idle_gaps(dev, host):
    """Idle seconds of the device between its first and last operation,
    summed by the innermost host operation under way when each gap began."""
    iv = sorted((s, e) for _, s, e in dev)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    events = sorted(host, key=lambda r: r[1])
    out, open_, j = {}, [], 0
    for g0, g1 in gaps:
        while j < len(events) and events[j][1] <= g0:
            open_.append(events[j])
            j += 1
        open_ = [r for r in open_ if r[2] > g0]
        name = max(open_, key=lambda r: r[1])[0] if open_ else "(no host op)"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda r: -r[1])


class Run:
    """What the per-layer readers read: the cell, its spans, the untraced
    window's wall time and the traced segment."""

    def __init__(self, cell, window, prof):
        self.cell = cell
        self.spans = {"scene_setup_s": cell.scene_setup_s}
        self.window = window
        self.profile = prof

    def entry(self, name: str):
        """(bytes, device seconds) of the traced calls of the entry points
        that reader ``name`` names, or None where there was no such call."""
        rows = [(us, b) for n, us, b in self.profile["entries"] if n == name]
        if not rows:
            return None
        return sum(b for _, b in rows), sum(us for us, _ in rows) / 1e6


def reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(run)`` gives the value
    of per-layer metric ``name``, or None where it finds nothing."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"windbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_run(cell: Cell, seed: int, seconds: float, trace: bool,
               per_layer=(), started: Optional[float] = None):
    """Warm-up, window and (with ``trace``) the traced segment and readers.
    Returns a dict with the frames, e2e numbers, captures and metrics."""
    t0 = time.perf_counter()
    caps = Captures(cell.obstacles.shape, cell.device)
    t1 = time.perf_counter()
    warm_up(cell, seed, caps)
    phases = {"captures_s": t1 - t0, "warm_up_s": time.perf_counter() - t1}
    setup_s = process_age_s(started) if started is not None else None
    frame_ms, failed, steps, wall = frames(
        cell.system, cell.workload["frame_steps"], seconds, cell.device,
        caps, traffic.capture_points(seed, N_CAPTURES))
    out = dict(frame_ms=frame_ms, failed=failed, steps=steps, wall_s=wall,
               setup_s=setup_s, phases=phases, caps=caps, metrics={},
               breakdown=None, busy_s=None, window_s=None)
    if cell.device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            cell.device)
    if not trace:
        return out
    window = dict(wall_ms_per_step=wall / steps * 1e3)
    n_frames = max(1, math.ceil(PROFILE_MIN_STEPS /
                                cell.workload["frame_steps"]))
    readers = {name: reader(name) for name in per_layer}
    prof = profile(cell, n_frames, readers)
    run = Run(cell, window, prof)
    for name, mod in readers.items():
        value = mod.read(run)
        if value is not None:
            out["metrics"][name] = value
    dev_s = {}
    for name, s, e in prof["device"]:
        dev_s[name] = dev_s.get(name, 0.0) + (e - s) / 1e6
    out["busy_s"] = busy_us((s, e) for _, s, e in prof["device"]) / 1e6
    out["window_s"] = prof["window_s"]
    out["breakdown"] = {
        "device_ops": sorted(([k, v] for k, v in dev_s.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": idle_gaps(prof["device"], prof["host"])[:10]}
    return out


def _finite(x: float) -> float:
    """``x``, or infinity where it is NaN (so a max never drops it)."""
    return x if x == x else math.inf


def _gap(got, want) -> float:
    scale = float(want.abs().max())
    return _finite(float((got - want).abs().max())
                   / (scale if scale > 0 else 1.0))


def check(cell: Cell, seed: int, caps: Captures, device=None) -> Dict:
    """The three numbers of the check, computed by the float32 reference on
    ``device`` (the cell's by default) from the captures."""
    device = torch.device(device or cell.device)
    p = ref.params_of(cell.config)
    m = ref.build_masks(cell.obstacles, torch.float32, device)
    state = traffic.initial_state(cell.obstacles, cell.workload["init"],
                                  seed, device)
    start, steps, stats = 0.0, 0.0, 0.0

    def stats_gap(got, want):
        return max(_finite(abs(float(g) - float(w))
                           / max(abs(float(w)), 1e-30))
                   for g, w in zip(got, want))

    for got, got_stats in caps.start:
        state, st = ref.step(state, m, p)
        start = max(start, max(_gap(g.to(device), w)
                               for g, w in zip(got, state)))
        stats = max(stats, stats_gap(got_stats, st))
    del state
    for i in range(caps.taken):
        slot_in, slot_out = caps.window(i)
        inp = tuple(f.to(device) for f in caps.buf[slot_in])
        want, st = ref.step(inp, m, p)
        steps = max(steps, max(_gap(g.to(device), w)
                               for g, w in zip(caps.buf[slot_out], want)))
        stats = max(stats, stats_gap(caps.stats[slot_out], st))
        del inp, want
    return {"start_gap": start, "step_gap": steps, "stats_gap": stats,
            "captured": caps.taken}


def verdict(cell: Cell, numbers: Dict, failed: int):
    """(correct, the compared numbers each beside its limit)."""
    limits = cell.workload["limits"]
    # a NaN in the compared fields reads infinite, printed as null
    rows = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                "limit": limits[k]} for k in CHECKS}
    rows["captured_steps"] = {"value": numbers["captured"],
                              "limit": N_CAPTURES}
    rows["failed_frames"] = {"value": failed, "limit": 0}
    ok = (all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
              for k in CHECKS)
          and numbers["captured"] == N_CAPTURES and failed == 0)
    return ok, rows
