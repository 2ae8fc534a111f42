"""The step's and the set-up's spans on the CPU: each phase of
``simulation_step`` in its ``fst.*`` span, nested in ``fst.step``, as host
rows that are not user annotations (so a profile with the card's activity
adds no device row for them); the same numbers with the profiler on and
off; no RecordFunction at all with the profiler off; the set-up spans
timed into ``WindTunnel.setup_s`` (the first step once, its steps bitwise
the plain functions'); the process's records of the kernel library's load
and each C entry point's first launch, through the entry table with a fake
library; and the benchmark's readers of those records."""

import functools
import pathlib
import sys
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import _build
from fluid_simulation_tpu_torch.models import windtunnel
from fluid_simulation_tpu_torch.scene.primitives import (
    add_sphere, empty_obstacles)
from fluid_simulation_tpu_torch.utils import profiling

torch.set_num_threads(1)

CPU = "cpu"
SMALL = SimParams(width=12, height=8, depth=6, acc=2)
PHASES = ("fst.inlets", "fst.diffuse", "fst.advect", "fst.advect_density",
          "fst.stats")
CASES = {"split": SMALL.replace(mode="split"),
         "compat": SMALL,
         "fast": SMALL.replace(mode="fast"),
         "split vorticity": SMALL.replace(mode="split", vorticity=2.0),
         "fast noslip vorticity": SMALL.replace(mode="fast",
                                                wall_mode="noslip",
                                                vorticity=2.0)}


def _sphere():
    return add_sphere(empty_obstacles(12, 8, 6), cx=5, cy=4, cz=3, radius=2)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("fst.")]


def _children(events, parent):
    return sorted(e.name for e in events
                  if e.cpu_parent is not None and e.cpu_parent.id == parent.id)


@pytest.mark.parametrize("label", list(CASES))
def test_each_step_nests_its_phases(label):
    p = CASES[label]
    wt = WindTunnel(p, obstacles=_sphere(), device=CPU)
    wt.step()
    _, events = _profiled(lambda: wt.simulate(2))
    steps = [e for e in events if e.name == "fst.step"]
    assert len(steps) == 2
    assert all(e.cpu_parent is None for e in steps)
    want = sorted(PHASES + ("fst.project", "fst.project")
                  + (("fst.confine",) if p.vorticity else ()))
    for step in steps:
        assert _children(events, step) == want
    bounds = [e for e in events if e.name == "fst.bounds"]
    # split pads the advected velocity and density, fast the velocity and
    # sets the density's bounds, compat sets each of its four advects'
    per_step = {"split": 2, "fast": 2, "compat": 4}[p.mode]
    assert len(bounds) == 2 * per_step
    assert {e.cpu_parent.name for e in bounds} <= {"fst.advect",
                                                  "fst.advect_density"}


@pytest.mark.parametrize("label", list(CASES))
def test_each_trilinear_sample_in_its_span(label):
    """compat and fast run each of a step's four trilinear samples in
    ``fst.gather``, three of the velocity inside ``fst.advect`` and the
    density's inside ``fst.advect_density``; split samples none."""
    p = CASES[label]
    wt = WindTunnel(p, obstacles=_sphere(), device=CPU)
    wt.step()
    _, events = _profiled(lambda: wt.simulate(2))
    gathers = [e.cpu_parent.name for e in events if e.name == "fst.gather"]
    if p.mode == "split":
        assert gathers == []
        return
    assert sorted(gathers) == (["fst.advect"] * 6
                               + ["fst.advect_density"] * 2)
    assert not [e for e in events if e.cpu_parent is not None
                and e.cpu_parent.name == "fst.gather"]


@pytest.mark.parametrize("mode", ["compat", "fast", "split"])
def test_each_backtrace_in_its_span(mode):
    """compat backtraces each of its four advects in ``fst.backtrace``,
    the velocity's three inside ``fst.advect`` and the density's inside
    ``fst.advect_density``; fast backtraces twice, the velocity's shared
    one and the density's; split opens none."""
    wt = WindTunnel(SMALL.replace(mode=mode), obstacles=_sphere(), device=CPU)
    wt.step()
    _, events = _profiled(wt.step)
    parents = sorted(e.cpu_parent.name for e in events
                     if e.name == "fst.backtrace")
    assert parents == {"compat": ["fst.advect"] * 3 + ["fst.advect_density"],
                       "fast": ["fst.advect", "fst.advect_density"],
                       "split": []}[mode]
    assert not [e for e in events if e.cpu_parent is not None
                and e.cpu_parent.name == "fst.backtrace"]


def test_spans_are_not_user_annotations():
    wt = WindTunnel(SMALL.replace(mode="split"), device=CPU)

    def run():
        with record_function("user.span"):
            return wt.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    flags = {e.name: e.is_user_annotation for e in prof.events()
             if e.name.startswith(("fst.", "user."))}
    # the check tells the two kinds apart
    assert flags.pop("user.span") is True
    # the tunnel's first step, so its own span too
    assert set(flags) == {"fst.first_step", "fst.step", "fst.bounds",
                          "fst.project", "fst.stats"} | set(PHASES)
    assert not any(flags.values())


@pytest.mark.parametrize("mode", ["split", "compat", "fast"])
def test_numbers_are_the_same_with_the_profiler_on(mode):
    p = SMALL.replace(mode=mode, vorticity=2.0)
    a = WindTunnel(p, obstacles=_sphere(), device=CPU)
    b = WindTunnel(p, obstacles=_sphere(), device=CPU)
    a.add_density(4, 4, 3, 1.0)
    b.add_density(4, 4, 3, 1.0)
    sa = a.simulate(3)
    (sb, _) = _profiled(lambda: b.simulate(3))
    for x, y in zip(torch.utils._pytree.tree_leaves(sa),
                    torch.utils._pytree.tree_leaves(sb)):
        assert torch.equal(x, y) or (x.isnan().all() and y.isnan().all())


def test_no_record_function_with_the_profiler_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"RecordFunction {name} entered")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    wt = WindTunnel(SMALL.replace(mode="split", vorticity=2.0),
                    obstacles=_sphere(), device=CPU)
    wt.simulate(2)
    with pytest.raises(AssertionError, match="fst.step"):
        _profiled(wt.step)


def _fields(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _bitwise(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(_fields(a), _fields(b)))


def test_setup_spans_are_timed():
    wt = WindTunnel(SMALL, obstacles=_sphere(), device=CPU)
    # a tunnel on the host opens no context span, and keeps no first step
    # before it has stepped
    assert set(wt.setup_s) == {"fst.setup", "fst.setup.masks",
                               "fst.setup.state"}
    assert all(v > 0 for v in wt.setup_s.values())
    assert wt.setup_s["fst.setup"] >= (wt.setup_s["fst.setup.masks"]
                                       + wt.setup_s["fst.setup.state"])
    _, events = _profiled(lambda: WindTunnel(SMALL, device=CPU).step())
    setup, = [e for e in events if e.name == "fst.setup"]
    assert _children(events, setup) == ["fst.setup.masks", "fst.setup.state"]
    first, = [e for e in events if e.name == "fst.first_step"]
    assert first.cpu_parent is None
    assert _children(events, first) == ["fst.step"]

    # the first step, by ``step`` or ``simulate``, is timed once, and every
    # step is bitwise the plain functions' from the same state
    twin = WindTunnel(SMALL, obstacles=_sphere(), device=CPU)
    sim = WindTunnel(SMALL, obstacles=_sphere(), device=CPU)
    for t in (wt, twin, sim):
        t.add_density(4, 4, 3, 1.0)
    state, masks, p = twin.state, twin.masks, twin.params
    want = []
    for _ in range(3):
        state, st = windtunnel.simulation_step(state, masks, p)
        want.append((state, st))
    want_sim = windtunnel.simulate(twin.state, masks, p, 3, record=True)

    got = []
    for i in range(3):
        st = wt.step()
        got.append((wt.state, st))
        assert "fst.first_step" in wt.setup_s
        if i == 0:
            first_s = wt.setup_s["fst.first_step"]
            assert first_s > 0
        assert wt.setup_s["fst.first_step"] is first_s
    assert _bitwise(got, want)
    assert "step" not in vars(wt) and "simulate" not in vars(wt)
    assert _bitwise(sim.simulate(3, record=True), want_sim)
    first_s = sim.setup_s["fst.first_step"]
    assert _bitwise(sim.simulate(2), windtunnel.simulate(
        want_sim[0], masks, p, 2))
    assert sim.setup_s["fst.first_step"] is first_s


class _FakeFn:
    """A C entry point: records each call's arguments, returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


def test_first_launch_is_recorded_once(monkeypatch):
    """``library()`` (its real body, with a fake build and a fake
    ``ctypes.CDLL``) puts a first-call wrapper in the entry table; each
    entry's first call, by ``call`` or ``launch``, is timed into the
    process record under its name and puts the ctypes function itself in
    the table, so a second call reaches the same function with the same
    arguments and records nothing. The library's load is a span of its
    own, before the first launch's and outside it."""
    calls = []

    class FakeLib:
        def __init__(self, path):
            assert path == "fake.so"

        def __getattr__(self, name):
            fn = _FakeFn(name, calls)
            setattr(self, name, fn)
            return fn

    def fake_build():
        time.sleep(0.2)
        return pathlib.Path("fake.so")

    record = {"fst.first_launch": {}}
    monkeypatch.setattr(_build, "PROCESS_SETUP", record)
    monkeypatch.setattr(_build, "_ENTRY", {})
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "library",
                        functools.cache(_build.library.__wrapped__))
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 77, raising=False)

    _, events = _profiled(lambda: _build.call("fst_prestep_blocks", 5))
    assert calls == [("fst_prestep_blocks", (5,))]
    assert set(record) == {"fst.first_launch", "fst.library",
                           "fst.library.build", "fst.library.load", "built"}
    assert record["built"] == 0
    assert record["fst.library"] >= (record["fst.library.build"]
                                     + record["fst.library.load"])
    first = record["fst.first_launch"]
    assert list(first) == ["fst_prestep_blocks"]
    # the library's 0.2 s build is not in the first launch's time
    assert 0 < first["fst_prestep_blocks"] < 0.2 <= record["fst.library"]
    lib, = [e for e in events if e.name == "fst.library"]
    launch, = [e for e in events if e.name == "fst.first_launch"]
    assert _children(events, lib) == ["fst.library.build",
                                      "fst.library.load"]
    assert lib.cpu_parent is None and launch.cpu_parent is None
    assert lib.time_range.end <= launch.time_range.start
    assert _build._ENTRY["fst_prestep_blocks"] is getattr(
        _build.library(), "fst_prestep_blocks")

    recorded = first["fst_prestep_blocks"]
    _build.call("fst_prestep_blocks", 5)
    _, events = _profiled(lambda: _build.launch("fst_probe_add1", 0, 1, 2))
    _build.launch("fst_probe_add1", 0, 1, 2)
    assert calls == [("fst_prestep_blocks", (5,))] * 2 + [
        ("fst_probe_add1", (1, 2, 77))] * 2
    assert first["fst_prestep_blocks"] is recorded
    assert list(first) == ["fst_prestep_blocks", "fst_probe_add1"]
    assert [e.name for e in events] == ["fst.first_launch"]


SETUP_READERS = {"context_setup_s": "fst.setup.context",
                 "first_step_s": "fst.first_step",
                 "library_load_s": "fst.library",
                 "first_launch_s": "fst.first_launch"}


@pytest.mark.parametrize("name", list(SETUP_READERS))
def test_setup_reader_reads_the_record_or_nothing(name, monkeypatch):
    """Each set-up reader of the benchmark returns the port's record, and
    nothing where the port keeps none: a tunnel on the host (no context),
    a tunnel before its first step, a system with no tunnel, a process
    that loaded no library or launched no entry point, or a program with
    no process record at all."""
    from windbench import harness
    reader = harness.reader(name)

    def run(system):
        cell = types.SimpleNamespace(scene_setup_s=0.0, system=system)
        return harness.Run(cell, {}, {})

    def port(setup_s):
        return types.SimpleNamespace(wt=types.SimpleNamespace(
            setup_s=setup_s))

    key = SETUP_READERS[name]
    full = port({"fst.setup": 1.0, "fst.setup.context": 0.5,
                 "fst.first_step": 0.25})
    bare = port({"fst.setup": 1.0})
    monkeypatch.setattr(profiling, "PROCESS_SETUP", {"fst.first_launch": {}})
    for system in (bare, object(), types.SimpleNamespace(wt=object())):
        assert reader.read(run(system)) is None
    if key.startswith("fst.setup") or key == "fst.first_step":
        assert reader.read(run(full)) == full.wt.setup_s[key]
        return
    assert reader.read(run(full)) is None
    monkeypatch.setattr(profiling, "PROCESS_SETUP", {
        "fst.library": 0.125, "built": 0,
        "fst.first_launch": {"fst_a": 0.5, "fst_b": 0.25}})
    assert reader.read(run(bare)) == {"library_load_s": 0.125,
                                      "first_launch_s": 0.75}[name]
    monkeypatch.delattr(profiling, "PROCESS_SETUP")
    assert reader.read(run(full)) is None
    monkeypatch.delitem(sys.modules, profiling.__name__)
    assert reader.read(run(full)) is None
