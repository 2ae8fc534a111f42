"""Each configuration names the plain reference that its runs are held to,
and the harness finds it by that name: on the CPU at 24x12x10, the
t512_split_sphere cell's files with the grid and sphere cut down, as in
``test_windbench_control.py``. A reference module planted under
``windbench.reference`` is the one that the check and the control use; a
configuration that its reference does not compute, or that names no
reference, fails in ``harness.Cell`` before anything is built."""

import re
import sys
import types

import pytest
import torch

from windbench import harness, run, traffic
from windbench.reference import step as split_ref

SEED = 2 ** 31 + 4243
PLANTED = "windbench.reference.planted"


def _planted(monkeypatch, factor):
    """Plant ``reference/planted``: ``step.py`` with its density, and so
    the density sum, times ``factor``; records each step it runs."""
    mod = types.ModuleType(PLANTED)
    mod.params_of, mod.build_masks = split_ref.params_of, split_ref.build_masks
    mod.calls = []

    def step(state, masks, params):
        mod.calls.append(params)
        (vx, vy, vz, dens), (dsum, max_div) = split_ref.step(state, masks,
                                                             params)
        return (vx, vy, vz, dens * factor), (dsum * factor, max_div)

    mod.step = step
    monkeypatch.setitem(sys.modules, PLANTED, mod)
    return mod


def _config(**kw):
    return dict(traffic.load_json("configs", "tunnel512_split"), width=24,
                height=12, depth=10, **kw)


def _workload():
    return dict(traffic.load_json("workloads", "t512_split_sphere"),
                scene={"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
                frame_steps=3)


def _run(config):
    return run.execute(harness.benchmark(), "t512_split_sphere", SEED, 0.6,
                       False, torch.device("cpu"), workload=_workload(),
                       config=config)


@pytest.mark.parametrize("factor, correct", [(1 + 1e-3, False), (1.0, True)],
                         ids=["density_off", "unchanged"])
def test_check_uses_the_configurations_reference(monkeypatch, factor,
                                                 correct):
    planted = _planted(monkeypatch, factor)
    result, lines = _run(_config(reference="planted"))
    assert result["correct"] is correct, lines
    # two warm-up steps, and one for each captured window step
    assert len(planted.calls) == harness.WARMUP_STEPS + harness.N_CAPTURES
    stats = result["checks"]["stats_gap"]
    assert (stats["value"] > stats["limit"]) is not correct, lines


def test_control_runs_the_configurations_reference(monkeypatch):
    planted = _planted(monkeypatch, 1 + 1e-3)
    cfg = _config(reference="planted")
    obs = traffic.scene(_workload()["scene"], cfg)
    state = traffic.initial_state(obs, _workload()["init"], SEED, "cpu")
    control = harness.ReferenceSystem(cfg, obs, "cpu", dtype=torch.float32)
    control.set_state(state)
    control.step()
    want, _ = split_ref.step(state, split_ref.build_masks(obs),
                             split_ref.params_of(cfg))
    assert len(planted.calls) == 1
    got = control.state()
    assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    assert torch.equal(got[3], want[3] * (1 + 1e-3))


class Recorded:
    """A stub system that records whether it was constructed."""

    built = []

    def __init__(self, config, obstacles, device):
        self.built.append(config)


def test_a_mode_the_reference_refuses_fails_before_set_up(monkeypatch):
    scenes = []
    monkeypatch.setattr(traffic, "scene", lambda *args: scenes.append(args))
    monkeypatch.setattr(Recorded, "built", [])
    cfg = dict(traffic.load_json("configs", "tunnel128_split"), mode="compat")
    with pytest.raises(NotImplementedError, match="split mode"):
        harness.Cell("t128_split_sphere", "cpu", system=Recorded,
                     config=cfg)
    assert Recorded.built == [] and scenes == []


@pytest.mark.parametrize("name", ["no_such_reference", "../step", None],
                         ids=["no_module", "not_a_name", "absent"])
def test_a_reference_that_is_not_there_fails_in_cell(monkeypatch, name):
    monkeypatch.setattr(Recorded, "built", [])
    cfg = _config()
    if name is None:
        del cfg["reference"]
    else:
        cfg["reference"] = name
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        harness.Cell("t512_split_sphere", "cpu", system=Recorded,
                     workload=_workload(), config=cfg)
    assert Recorded.built == []
