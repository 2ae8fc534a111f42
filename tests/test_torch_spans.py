"""The step's and the set-up's spans on the CPU: each phase of
``simulation_step`` in its ``fst.*`` span, nested in ``fst.step``, as host
rows that are not user annotations (so a profile with the card's activity
adds no device row for them); the same numbers with the profiler on and
off; no RecordFunction at all with the profiler off; and the set-up spans
timed into ``WindTunnel.setup_s``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fluid_simulation_tpu_torch import SimParams, WindTunnel
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
    # split pads the advected velocity and density, fast the velocity
    per_step = {"split": 2, "fast": 1, "compat": 0}[p.mode]
    assert len(bounds) == 2 * per_step
    assert {e.cpu_parent.name for e in bounds} <= {"fst.advect",
                                                  "fst.advect_density"}


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
    assert set(flags) == {"fst.step", "fst.bounds", "fst.project",
                          "fst.stats"} | set(PHASES)
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


def test_setup_spans_are_timed():
    wt = WindTunnel(SMALL, obstacles=_sphere(), device=CPU)
    assert set(wt.setup_s) == {"fst.setup", "fst.setup.masks",
                               "fst.setup.state"}
    assert all(v > 0 for v in wt.setup_s.values())
    assert wt.setup_s["fst.setup"] >= (wt.setup_s["fst.setup.masks"]
                                       + wt.setup_s["fst.setup.state"])
    _, events = _profiled(lambda: WindTunnel(SMALL, device=CPU))
    setup, = [e for e in events if e.name == "fst.setup"]
    assert _children(events, setup) == ["fst.setup.masks", "fst.setup.state"]
