"""The benchmark's plain compat step (``windbench/reference/compat.py``)
against the port's compat step on the CPU, and the check it decides.

- From seeded random fields, two steps of ``WindTunnel`` in compat mode
  equal two reference steps bitwise, field by field and stat by stat: at
  24x12x10 and 32x16x16, empty and with a sphere, with the kernels' plain
  versions (``use_pallas``) and the plain torch step. Both compute every
  value in float32 in the same order, so no tolerance is needed.
- The harness's check of the ``t128_compat_sphere`` cell at 24x12x10 (its
  files with the grid and sphere cut down): the program correct with every
  gap 0; the reference in bfloat16 in its place (the low-precision
  control), the port with the advection chain broken (vy backtraced through
  the pre-advection vx), and the split step of ``reference/step.py`` in
  compat's place, each not correct.
- ``tunnel128_compat`` is ``SimParams()``, every field at its default, and
  the compat reference refuses what it does not compute."""

import dataclasses
import functools
from unittest import mock

import pytest
import torch

from fluid_simulation_tpu_torch import FluidState, SimParams, WindTunnel
from fluid_simulation_tpu_torch.models import windtunnel
from windbench import harness, run, traffic
from windbench.reference import compat as ref

torch.set_num_threads(1)

CELL = "t128_compat_sphere"
CONFIG = "tunnel128_compat"
SEED = 2 ** 31 + 1818
GRIDS = {"24x12x10": ((24, 12, 10), [8, 6, 5], 3.5),
         "32x16x16": ((32, 16, 16), [10, 8, 8], 4.0)}


def _config(grid):
    (w, h, d), _, _ = GRIDS[grid]
    return dict(traffic.load_json("configs", CONFIG), width=w, height=h,
                depth=d)


def _scene(grid, kind):
    _, center, radius = GRIDS[grid]
    if kind == "empty":
        return {"kind": "empty"}
    return {"kind": "sphere", "center": center, "radius": radius}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("scene", ["sphere", "empty"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_reference_equals_port_compat_step(grid, scene, use_pallas):
    cfg = _config(grid)
    p = SimParams(**{k: cfg[k] for k in SimParams.__dataclass_fields__})
    p = p.replace(use_pallas=use_pallas)
    obs = traffic.scene(_scene(grid, scene), cfg)
    init = traffic.load_json("workloads", CELL)["init"]
    state = traffic.initial_state(obs, init, SEED, "cpu")
    wt = WindTunnel(p, obstacles=obs, device="cpu")
    wt.state = FluidState(*state)
    m = ref.build_masks(obs)
    rp = ref.params_of(cfg)
    for _ in range(2):
        st = wt.step()
        state, (dsum, max_div) = ref.step(state, m, rp)
        for got, want in zip(wt.state, state):
            assert torch.equal(got, want)
        assert float(st.density_sum) == float(dsum)
        assert float(st.max_divergence) == float(max_div)


def test_reference_leaves_its_input_unchanged():
    cfg = _config("24x12x10")
    obs = traffic.scene(_scene("24x12x10", "sphere"), cfg)
    init = traffic.load_json("workloads", CELL)["init"]
    state = traffic.initial_state(obs, init, SEED, "cpu")
    copy = tuple(f.clone() for f in state)
    ref.step(state, ref.build_masks(obs), ref.params_of(cfg))
    assert all(torch.equal(a, b) for a, b in zip(state, copy))


class BrokenChain(harness.PortSystem):
    """The port with vy backtraced through the projected vx, not through
    the vx its own advect just produced."""

    def step(self):
        real = windtunnel.advect
        projected = {}

        def advect(b, prev, vx, vy, vz, *args):
            if b == 1:
                projected["vx"] = vx
            elif b == 2:
                vx = projected["vx"]
            return real(b, prev, vx, vy, vz, *args)

        with mock.patch.object(windtunnel, "advect", advect):
            return super().step()


def split_in_compats_place(config, obstacles, device):
    """``reference/step.py``'s split step, in float32, as the system."""
    return harness.ReferenceSystem(dict(config, mode="split",
                                        reference="step"),
                                   obstacles, device, dtype=torch.float32)


def _run(system):
    wl = dict(traffic.load_json("workloads", CELL),
              scene=_scene("24x12x10", "sphere"), frame_steps=3)
    return run.execute(harness.benchmark(), CELL, SEED, 0.6, False,
                       torch.device("cpu"), system=system, workload=wl,
                       config=_config("24x12x10"))


def test_program_is_correct():
    result, lines = _run(harness.PortSystem)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(row["value"] == 0 for k, row in result["checks"].items()
               if k in harness.CHECKS), lines


@pytest.mark.parametrize("system", [
    functools.partial(harness.ReferenceSystem, dtype=torch.bfloat16),
    BrokenChain, split_in_compats_place],
    ids=["bf16_control", "broken_chain", "split_step"])
def test_faults_fail_a_limit(system):
    result, lines = _run(system)
    assert not result["correct"], lines
    checks = result["checks"]
    assert any(checks[k]["value"] is None
               or checks[k]["value"] > checks[k]["limit"]
               for k in harness.CHECKS), lines
    assert checks["failed_frames"]["value"] == 0, lines


def test_config_is_the_simparams_default():
    cfg = traffic.load_json("configs", CONFIG)
    assert {k: cfg[k] for k in SimParams.__dataclass_fields__} == \
        dataclasses.asdict(SimParams())
    assert cfg["reference"] == "compat" and cfg["reduced"] == []


@pytest.mark.parametrize("change", [
    dict(mode="split"), dict(mode="fast"), dict(vorticity=2.0),
    dict(use_visc_for_velocity=True), dict(solver="jacobi")],
    ids=["split", "fast", "vorticity", "visc", "jacobi"])
def test_params_of_refuses_what_it_does_not_compute(change):
    with pytest.raises(NotImplementedError, match="compat"):
        ref.params_of(dict(traffic.load_json("configs", CONFIG), **change))
