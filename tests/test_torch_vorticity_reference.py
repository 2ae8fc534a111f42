"""The benchmark's plain split step with vorticity confinement
(``windbench/reference/vorticity.py``) against the port's step on the CPU,
the check it decides, and the readers ``confine_roofline`` and
``confine_launches``.

- From seeded random fields, two steps of ``WindTunnel`` with no-slip walls
  and vorticity 5.0 equal two reference steps bitwise, field by field and
  stat by stat: at 24x12x10 and 32x16x16, empty and with a sphere, on the
  plain torch step and on the kernels' plain versions (``use_pallas``), on
  the resident route and on the streamed one (its size gate lowered).
- The reference's confinement leaves a uniform flow, the solids' fluid
  neighbours and the ghost faces as they were.
- The harness's check of the ``t512_noslip_vort_sphere`` cell at 24x12x10
  (its files with the grid and sphere cut down): the program correct with
  every gap 0; the reference in bfloat16 in its place (the low-precision
  control), the port with vorticity 0, the port with reference walls, the
  reference with its confinement left out, and ``step.py``'s split step
  (reference walls, no confinement), each not correct.
- ``tunnel512_noslip_vort`` carries every ``SimParams`` field, as
  ``tunnel512_split`` but for the walls and the vorticity, and the
  reference refuses what it does not compute.
- ``confine_roofline`` counts 955,351,232 B a call at 512x256x256 as a hand
  count gives it, and a traced CPU run calls its entry point once a step;
  ``confine_launches`` counts the enqueueing calls inside ``fst.confine``
  and reads nothing without the span."""

import dataclasses
import functools
import types
from unittest import mock

import pytest
import torch

from fluid_simulation_tpu_torch import FluidState, SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import linsolve_stream
from windbench import harness, run, traffic
from windbench.reference import vorticity as ref

torch.set_num_threads(1)

CELL = "t512_noslip_vort_sphere"
CONFIG = "tunnel512_noslip_vort"
ROOFLINE = "confine_roofline"
LAUNCHES = "confine_launches"
SEED = 2 ** 31 + 2828
GRIDS = {"24x12x10": ((24, 12, 10), [8, 6, 5], 3.5),
         "32x16x16": ((32, 16, 16), [10, 8, 8], 4.0)}
META = {"source", "assumed", "reduced", "guarantees", "deployment",
        "reference"}
NO_CELL = types.SimpleNamespace(scene_setup_s=0.0)


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
@pytest.mark.parametrize("use_pallas, streamed", [(False, False),
                                                  (True, False),
                                                  (True, True)],
                         ids=["plain", "resident", "streamed"])
def test_reference_equals_port_step(grid, scene, use_pallas, streamed,
                                    monkeypatch):
    if streamed:
        monkeypatch.setattr(linsolve_stream, "STREAM_MIN_CELLS", 1)
    cfg, obs, state = _seeded(grid, scene)
    p = SimParams(**{k: cfg[k] for k in SimParams.__dataclass_fields__})
    p = p.replace(use_pallas=use_pallas)
    wt = WindTunnel(p, obstacles=obs, device="cpu")
    assert linsolve_stream.streams(p.padded_shape) == streamed
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


def test_confinement_moves_only_the_swirling_fluid():
    """A uniform flow has no curl, so no force; the force is zero where
    ``keep_vel`` is (solids and their fluid neighbours) and on the ghost
    faces; elsewhere a seeded random flow moves."""
    cfg, obs, (vx, vy, vz, _) = _seeded("24x12x10", "sphere")
    m, p = ref.build_masks(obs), ref.params_of(cfg)
    uniform = tuple(torch.full_like(vx, c) for c in (3.0, -1.5, 0.25))
    assert all(torch.equal(a, b) for a, b in zip(
        ref.confine(*uniform, m.keep_vel, p), uniform))
    out = ref.confine(vx, vy, vz, m.keep_vel, p)
    still = m.keep_vel == 0
    inner = torch.zeros_like(still)
    inner[1:-1, 1:-1, 1:-1] = True
    for got, v in zip(out, (vx, vy, vz)):
        assert torch.equal(got[~inner], v[~inner])
        assert torch.equal(got[still], v[still])
        assert bool((got != v)[inner & ~still].any())


class ConfinementOff(harness.PortSystem):
    """The port with its confinement skipped (vorticity 0 in the config)."""

    def __init__(self, config, obstacles, device):
        super().__init__(dict(config, vorticity=0.0), obstacles, device)


def port_with_reference_walls(config, obstacles, device):
    return harness.PortSystem(dict(config, wall_mode="reference"), obstacles,
                              device)


class ReferenceWithoutConfinement(harness.ReferenceSystem):
    """This reference in float32 with its confinement left out: the split
    step with no-slip walls."""

    def __init__(self, config, obstacles, device):
        super().__init__(config, obstacles, device, dtype=torch.float32)

    def step(self):
        with mock.patch.object(ref, "confine", lambda vx, vy, vz, *a: (
                vx, vy, vz)):
            return super().step()


def split_reference_in_its_place(config, obstacles, device):
    """``reference/step.py``'s split step, in float32, as the system: it
    computes neither confinement nor no-slip walls (its ``signs`` refuses
    them for a scalar field), so it runs with the reference walls."""
    return harness.ReferenceSystem(dict(config, vorticity=0.0,
                                        wall_mode="reference",
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
    ConfinementOff, port_with_reference_walls, ReferenceWithoutConfinement,
    split_reference_in_its_place],
    ids=["bf16_control", "port_vorticity_0", "port_reference_walls",
         "no_confinement", "split_step"])
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
        width=512, height=256, depth=256, mode="split", wall_mode="noslip",
        vorticity=5.0))
    other = traffic.load_json("configs", "tunnel512_split")
    assert {k: v for k, v in cfg.items() if k not in META} == \
        dict({k: v for k, v in other.items() if k not in META},
             wall_mode="noslip", vorticity=5.0)
    assert cfg["reference"] == "vorticity" and cfg["reduced"] == []
    assert cfg["guarantees"] == {"dtype": "float32", "solver": "rbgs",
                                 "acc": 15, "mode": "split"}
    assert set(cfg["assumed"]) >= {"width", "vorticity", "solver",
                                   "div_stats", "step_stats", "mode"}


@pytest.mark.parametrize("change", [
    dict(mode="compat"), dict(mode="fast"), dict(vorticity=0.0),
    dict(vorticity=-1.0), dict(use_visc_for_velocity=True),
    dict(solver="jacobi")],
    ids=["compat", "fast", "vorticity_0", "vorticity_negative", "visc",
         "jacobi"])
def test_params_of_refuses_what_it_does_not_compute(change):
    with pytest.raises(NotImplementedError, match="vorticity"):
        ref.params_of(dict(traffic.load_json("configs", CONFIG), **change))


def test_roofline_bytes_at_512x256x256():
    mod = harness.reader(ROOFLINE)
    D, H, W = 256, 256, 512
    interior, padded = D * H * W, (D + 2) * (H + 2) * (W + 2)
    # three padded velocities and the interior keep in, three padded out
    assert 4 * padded == 136_855_584 and 4 * interior == 134_217_728
    # shapes only: the count reads no value
    vel = torch.empty(D + 2, H + 2, W + 2, device="meta")
    keep = torch.empty(D + 2, H + 2, W + 2, device="meta")[1:-1, 1:-1, 1:-1]
    got = mod.call_bytes("confinement", (vel, vel, vel, keep, 5.0, 0.05), {})
    assert got == 4 * (6 * padded + interior) == 955_351_232
    assert got / mod.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.2852,
                                                             abs=1e-4)


def _traced_cell():
    cfg = _config("24x12x10")
    wl = dict(traffic.load_json("workloads", CELL),
              scene=_scene("24x12x10", "sphere"), frame_steps=1)
    cell = harness.Cell(CELL, torch.device("cpu"), workload=wl, config=cfg)
    harness.warm_up(cell, SEED, harness.Captures(cell.obstacles.shape,
                                                 cell.device))
    return cell


def test_traced_run_on_the_cpu_calls_the_entry_point_once_a_step():
    """The step calls the confinement once, between the advection's padding
    and the second projection, inside ``fst.confine``. The CPU launches no
    kernel, so the roofline reads nothing and the launches read 0."""
    cell = _traced_cell()
    readers = {name: harness.reader(name) for name in (ROOFLINE, LAUNCHES)}
    prof = harness.profile(cell, 2, readers)
    mod = readers[ROOFLINE]
    assert [b for n, _, b in prof["entries"] if n == ROOFLINE] == \
        [mod.bytes_moved(10, 12, 24)] * prof["steps"]
    names = [n for n, _, _ in prof["host"]]
    assert names.count("fst.confine") == prof["steps"] == 2
    run_ = harness.Run(cell, {}, prof)
    assert run_.entry(ROOFLINE)[1] == 0
    assert mod.read(run_) is None
    assert readers[LAUNCHES].read(run_) == 0


# two steps (us): enqueueing calls inside and outside the confinements, a
# query that enqueues nothing, and the readback's launch outside every step
HOST = [("windbench.step", 0.0, 1000.0),
        ("fst.step", 10.0, 990.0),
        ("fst.advect", 100.0, 300.0),
        ("cudaLaunchKernel", 120.0, 130.0),
        ("fst.confine", 400.0, 600.0),
        ("cudaLaunchKernel", 410.0, 420.0),
        ("cudaGetDevice", 430.0, 431.0),
        ("cuLaunchKernel", 440.0, 450.0),
        ("cudaMemsetAsync", 460.0, 470.0),
        ("fst.project", 700.0, 900.0),
        ("cudaLaunchKernel", 710.0, 720.0),
        ("windbench.readback", 1000.0, 1200.0),
        ("cudaLaunchKernel", 1010.0, 1020.0),
        ("windbench.step", 2000.0, 2500.0),
        ("fst.step", 2010.0, 2490.0),
        ("fst.confine", 2100.0, 2300.0),
        ("cudaLaunchKernel", 2110.0, 2120.0),
        ("cudaLaunchKernelExC", 2130.0, 2140.0),
        ("cudaLaunchKernel", 2400.0, 2410.0)]


def _read_launches(host):
    prof = dict(host=host, device=[], steps=2)
    return harness.reader(LAUNCHES).read(harness.Run(NO_CELL, {}, prof))


def test_launches_inside_the_confinements():
    # 410, 440 and 460 in the first step's confinement, 2110 and 2130 in
    # the second's; 120, 710 and 2400 outside them, 1010 in the readback
    assert _read_launches(HOST) == 5 / 2


@pytest.mark.parametrize("drop", ["fst.confine", "fst.step"])
def test_launches_read_nothing_without_the_spans(drop):
    # a step without vorticity opens no fst.confine; a program without
    # fst.step has no steps to count over
    assert _read_launches([r for r in HOST if r[0] != drop]) is None
