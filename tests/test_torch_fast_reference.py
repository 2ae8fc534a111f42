"""The benchmark's plain fast step (``windbench/reference/fast.py``)
against the port's fast step on the CPU, the check it decides, and the byte
count of ``fast_advect_roofline``.

- From seeded random fields, two steps of ``WindTunnel`` in fast mode
  equal two reference steps bitwise, field by field and stat by stat: at
  24x12x10 and 32x16x16, empty and with a sphere, with the kernels' plain
  versions (``use_pallas``) and the plain torch step.
- The harness's check of the ``t512_fast_sphere`` cell at 24x12x10 (its
  files with the grid and sphere cut down): the program correct with every
  gap 0; the reference in bfloat16 in its place (the low-precision
  control), the port with its shared backtrace taken through the velocity
  saved before diffusion, the port in compat mode, and the compat
  reference in fast's place, each not correct.
- ``tunnel512_fast`` carries every ``SimParams`` field, as
  ``tunnel512_compat`` but in fast mode, and the fast reference refuses
  what it does not compute.
- ``fast_advect_roofline`` counts one backtrace and three gathers at
  512x256x256 as a hand count gives them, and a traced fast run on the CPU
  calls both entry points."""

import dataclasses
import functools
import types
from unittest import mock

import pytest
import torch

from fluid_simulation_tpu_torch import FluidState, SimParams, WindTunnel
from fluid_simulation_tpu_torch.models import windtunnel
from windbench import harness, run, traffic
from windbench.reference import compat
from windbench.reference import fast as ref

torch.set_num_threads(1)

CELL = "t512_fast_sphere"
CONFIG = "tunnel512_fast"
ROOFLINE = "fast_advect_roofline"
SEED = 2 ** 31 + 2424
GRIDS = {"24x12x10": ((24, 12, 10), [8, 6, 5], 3.5),
         "32x16x16": ((32, 16, 16), [10, 8, 8], 4.0)}
META = {"source", "assumed", "reduced", "guarantees", "deployment",
        "reference"}


def _config(grid):
    (w, h, d), _, _ = GRIDS[grid]
    return dict(traffic.load_json("configs", CONFIG), width=w, height=h,
                depth=d)


def _scene(grid, kind):
    _, center, radius = GRIDS[grid]
    if kind == "empty":
        return {"kind": "empty"}
    return {"kind": "sphere", "center": center, "radius": radius}


def _seeded(grid, scene):
    cfg = _config(grid)
    obs = traffic.scene(_scene(grid, scene), cfg)
    init = traffic.load_json("workloads", CELL)["init"]
    return cfg, obs, traffic.initial_state(obs, init, SEED, "cpu")


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("scene", ["sphere", "empty"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_reference_equals_port_fast_step(grid, scene, use_pallas):
    cfg, obs, state = _seeded(grid, scene)
    p = SimParams(**{k: cfg[k] for k in SimParams.__dataclass_fields__})
    p = p.replace(use_pallas=use_pallas)
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
    cfg, obs, state = _seeded("24x12x10", "sphere")
    copy = tuple(f.clone() for f in state)
    ref.step(state, ref.build_masks(obs), ref.params_of(cfg))
    assert all(torch.equal(a, b) for a, b in zip(state, copy))


def test_velocity_shares_one_backtrace():
    """The reference's three velocity samples backtrace through one field,
    the projected velocity, so they are taken at one set of coordinates."""
    cfg, obs, state = _seeded("24x12x10", "sphere")
    seen = []

    def advect(b, prev, vel, *args):
        seen.append((b, vel))
        return compat.advect(b, prev, vel, *args)

    with mock.patch.object(ref, "advect", advect):
        ref.step(state, ref.build_masks(obs), ref.params_of(cfg))
    assert [b for b, _ in seen] == [1, 2, 3, 0]
    assert all(vel is seen[0][1] for _, vel in seen[:3])
    assert not any(v is w for v, w in zip(seen[0][1], state[:3]))


class SavedBacktrace(harness.PortSystem):
    """The port with its shared backtrace taken through the velocity saved
    before diffusion, not through the projected field."""

    def step(self):
        real = windtunnel.backtrace
        saved = [f[1:-1, 1:-1, 1:-1] for f in windtunnel._apply_inlets(
            self.wt.state, self.wt.params)[0][:3]]

        def backtrace(vx_i, vy_i, vz_i, *args):
            return real(*saved, *args)

        with mock.patch.object(windtunnel, "backtrace", backtrace):
            return super().step()


def port_in_compat_mode(config, obstacles, device):
    return harness.PortSystem(dict(config, mode="compat"), obstacles, device)


def compat_in_fasts_place(config, obstacles, device):
    """``reference/compat.py``'s chained step, in float32, as the system."""
    return harness.ReferenceSystem(dict(config, mode="compat",
                                        reference="compat"),
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
    SavedBacktrace, port_in_compat_mode, compat_in_fasts_place],
    ids=["bf16_control", "saved_backtrace", "port_compat", "compat_step"])
def test_faults_fail_a_limit(system):
    result, lines = _run(system)
    assert not result["correct"], lines
    checks = result["checks"]
    assert any(checks[k]["value"] is None
               or checks[k]["value"] > checks[k]["limit"]
               for k in harness.CHECKS), lines
    assert checks["failed_frames"]["value"] == 0, lines


def test_config_carries_every_simparams_field():
    cfg = traffic.load_json("configs", CONFIG)
    assert set(cfg) - META == set(SimParams.__dataclass_fields__)
    fields = {k: cfg[k] for k in SimParams.__dataclass_fields__}
    assert fields == dataclasses.asdict(SimParams(
        width=512, height=256, depth=256, mode="fast"))
    other = traffic.load_json("configs", "tunnel512_compat")
    assert {k: v for k, v in cfg.items() if k not in META} == \
        dict({k: v for k, v in other.items() if k not in META}, mode="fast")
    assert cfg["reference"] == "fast" and cfg["reduced"] == []
    assert cfg["guarantees"] == {"dtype": "float32", "solver": "rbgs",
                                 "acc": 15, "mode": "fast"}


@pytest.mark.parametrize("change", [
    dict(mode="compat"), dict(mode="split"), dict(vorticity=2.0),
    dict(use_visc_for_velocity=True), dict(solver="jacobi")],
    ids=["compat", "split", "vorticity", "visc", "jacobi"])
def test_params_of_refuses_what_it_does_not_compute(change):
    with pytest.raises(NotImplementedError, match="fast"):
        ref.params_of(dict(traffic.load_json("configs", CONFIG), **change))


def test_roofline_bytes_at_512x256x256():
    mod = harness.reader(ROOFLINE)
    D, H, W = 256, 256, 512
    interior, padded = D * H * W, (D + 2) * (H + 2) * (W + 2)
    # three velocity interiors in; the coordinates are intermediate data
    backtrace = 4 * 3 * interior
    # padded prev in, one interior out
    gather = 4 * (padded + interior)
    assert (backtrace, gather) == (402_653_184, 271_073_312)
    # shapes only: the count reads no value
    vel = torch.empty(D, H, W, device="meta")
    prev = torch.empty(D + 2, H + 2, W + 2, device="meta")
    got = mod.call_bytes("backtrace", (vel, vel, vel, 0.05, W, H, D,
                                       torch.float32), {})
    got += 3 * mod.call_bytes("gather", (prev, vel, vel, vel), {})
    assert got == backtrace + 3 * gather == 1_215_873_120


def test_traced_fast_run_on_the_cpu_calls_both_entry_points():
    """On the CPU fast's density advect runs the plain backtrace and gather
    too: two backtraces and four gathers a step, none nested. The CPU
    launches no kernel, so the reader reads nothing."""
    cfg = _config("24x12x10")
    wl = dict(traffic.load_json("workloads", CELL),
              scene=_scene("24x12x10", "sphere"), frame_steps=1)
    cell = harness.Cell(CELL, torch.device("cpu"), workload=wl, config=cfg)
    harness.warm_up(cell, SEED, harness.Captures(cell.obstacles.shape,
                                                 cell.device))
    readers = {ROOFLINE: harness.reader(ROOFLINE)}
    prof = harness.profile(cell, 2, readers)
    D, H, W = 10, 12, 24
    mod = readers[ROOFLINE]
    step = ([mod.backtrace_bytes(D, H, W)] + [mod.gather_bytes(D, H, W)] * 3
            + [mod.backtrace_bytes(D, H, W), mod.gather_bytes(D, H, W)])
    assert [b for n, _, b in prof["entries"] if n == ROOFLINE] == step * 2
    run_ = harness.Run(types.SimpleNamespace(scene_setup_s=0.0), {}, prof)
    assert run_.entry(ROOFLINE)[1] == 0
    assert mod.read(run_) is None
