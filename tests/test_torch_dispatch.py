"""Dispatch guard for the port's CUDA branch, run on the CPU.

The kernel branch of every wrapper only runs on a card, so a fault there
(a wrong argument, a missing import, a wrong count) would pass every plain
CPU test. Here the branch is forced on for CPU tensors and each launcher
is swapped for a stub that checks what the real launcher would be given
(shape, dtype, contiguity, no aliasing of inputs) and writes the plain
result. The production split and compat steps then run through the real
wrappers, and the launch counters must show 3/2/2/2 and 3/2/0/0 per step.
Unported configurations must raise on the CUDA branch.
"""

import ctypes

import numpy as np
import pytest
import torch

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, _build, advect_split as k3, bounds as k4, linsolve as k1,
    project as k2, reset_launches)
from fluid_simulation_tpu_torch.models.windtunnel import (
    FluidState, init_state, simulation_step)
from fluid_simulation_tpu_torch.scene.masks import build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    add_sphere, empty_obstacles)

torch.set_num_threads(1)

W, H, D = 16, 8, 8
PAD = (D + 2, H + 2, W + 2)


def _operand(t, shape):
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert tuple(t.shape) == tuple(shape), (tuple(t.shape), shape)


def _distinct(*ts):
    ptrs = [t.data_ptr() for t in ts]
    assert len(set(ptrs)) == len(ptrs), "launcher operands alias"


def stub_k1(out, prev, b, a, c, acc, wall_mode):
    _operand(out, prev.shape)
    _operand(prev, out.shape)
    _distinct(out, prev)
    out.copy_(k1.rbgs_solve_plain(b, out, prev, a, c, acc, wall_mode))


def stub_k2(vx, vy, vz, rhs, p, acc, wall_mode):
    for t in (vx, vy, vz, rhs, p):
        _operand(t, vx.shape)
    _distinct(vx, vy, vz, rhs, p)
    assert not p.any(), "p must start at zero, ghosts included"
    res = k2.project_empty_plain(vx, vy, vz, acc, wall_mode)
    for dst, src in zip((vx, vy, vz), res):
        dst.copy_(src)


def stub_k3(prev, vx, vy, vz, a, b, out, dt):
    Bn, D2, H2, W2 = prev.shape
    for t, shape in ((prev, prev.shape), (vx, (D2, H2, W2)),
                     (vy, (D2, H2, W2)), (vz, (D2, H2, W2)),
                     (a, (Bn, D2, H2, W2 - 2)), (b, (Bn, D2, H2 - 2, W2 - 2)),
                     (out, (Bn, D2 - 2, H2 - 2, W2 - 2))):
        _operand(t, shape)
    _distinct(prev, a, b, out)
    out.copy_(k3.advect_split_plain(prev, vx, vy, vz, dt))


def stub_k4(smp, out, bs, wall_mode):
    B, Di, Hi, Wi = smp.shape
    assert B == len(bs)
    _operand(smp, smp.shape)
    _operand(out, (B, Di + 2, Hi + 2, Wi + 2))
    out.copy_(torch.stack(k4.pad_bounds_plain(smp, bs, wall_mode)))


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; launchers are stubs."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    for mod, stub in ((k1, stub_k1), (k2, stub_k2), (k3, stub_k3),
                      (k4, stub_k4)):
        monkeypatch.setattr(mod, "_launch", stub)
    reset_launches()
    yield
    reset_launches()


def _random_state(p, seed=0):
    rng = np.random.default_rng(seed)
    fields = [rng.uniform(-2, 2, size=p.padded_shape) for _ in range(3)]
    fields[0] += 20
    fields.append(rng.uniform(0, 0.01, size=p.padded_shape))
    return [torch.tensor(f, dtype=torch.float32) for f in fields]


@pytest.mark.parametrize("mode,counts", [
    ("split", (3, 2, 2, 2)), ("compat", (3, 2, 0, 0)), ("fast", (3, 2, 0, 1))])
def test_production_step_launch_counts(card, mode, counts):
    p = SimParams(width=W, height=H, depth=D, acc=4, mode=mode)
    wt = WindTunnel(p)
    wt.state = FluidState(*_random_state(p))
    start = wt.state
    wt.simulate(2)
    per_step = tuple(LAUNCHES[k] / 2 for k in
                     ("rbgs_solve", "project_empty", "advect_split",
                      "pad_bounds"))
    assert per_step == counts

    # the kernel branch computes what the plain step computes
    ref = start
    for _ in range(2):
        ref, _ = simulation_step(ref, wt.masks, wt.params.replace(
            use_pallas=False))
    for a, b in zip(wt.state, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_reference_run_launches_nothing(card):
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="split",
                  use_pallas=False)
    WindTunnel(p).simulate(1)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("change", [
    dict(vorticity=5.0), dict(dtype="bfloat16"), dict(advect_window=4),
    dict(batched=True), "sphere"])
def test_unported_config_raises_on_card(card, change):
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="split")
    obs = None
    if change == "sphere":
        obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2)
    else:
        p = p.replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WindTunnel(p, obstacles=obs)
    # simulation_step itself refuses too, not only the constructor
    p = p.replace(empty_scene=obs is None)
    masks = build_masks(obs if obs is not None else empty_obstacles(W, H, D))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        simulation_step(init_state(p), masks, p)
    assert set(LAUNCHES.values()) == {0}


def test_wrappers_refuse_unported_operands(card):
    f = torch.zeros(PAD)
    keep = torch.ones(PAD)
    with pytest.raises(NotImplementedError, match="B5"):
        k1.rbgs_solve(1, f, f.clone(), 0.5, 4.0, keep=keep)
    smp = torch.zeros((1, D, H, W))
    with pytest.raises(NotImplementedError, match="B7"):
        k4.pad_bounds(smp, (0,), fluid_i=torch.ones((D, H, W)),
                      keep_i=torch.ones((D, H, W)))
    bf = torch.zeros(PAD, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A11"):
        k2.project_empty(bf, bf.clone(), bf.clone())
    with pytest.raises(ValueError, match="contiguous"):
        k1.rbgs_solve(0, f.transpose(0, 2), f.transpose(0, 2).clone(), 1.0,
                      6.0)
    with pytest.raises(ValueError, match="shape"):
        k3.advect_split(torch.zeros((3,) + PAD), f, f, torch.zeros((4, 4, 4)),
                        0.05)
    assert set(LAUNCHES.values()) == {0}


def test_wrapper_outputs_do_not_alias_inputs(card):
    rng = np.random.default_rng(3)
    vx, vy, vz, g = (torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
                     for _ in range(4))
    before = [t.clone() for t in (vx, vy, vz, g)]
    out1 = k1.rbgs_solve(1, vx, g, 0.5, 4.0, acc=2)
    out2 = k2.project_empty(vx, vy, vz, acc=2)
    out3 = k3.advect_split(torch.stack([vx, vy]), vx, vy, vz, 0.05)
    out4 = k4.pad_bounds(out3, (1, 2))
    for a, b in zip((vx, vy, vz, g), before):
        assert torch.equal(a, b)
    for t in (out1, *out2):
        assert t.data_ptr() not in {x.data_ptr() for x in (vx, vy, vz, g)}
    assert len(out4) == 2 and out4[0].shape == PAD
    assert LAUNCHES == {"rbgs_solve": 1, "project_empty": 1,
                        "advect_split": 1, "pad_bounds": 1}


def test_launch_error_raises(monkeypatch):
    """A nonzero cudaGetLastError() from a C entry point is an exception."""
    class FakeLib:
        @staticmethod
        def fst_rbgs_half(*args):
            return 9

        @staticmethod
        def fst_error_string(code):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "library", lambda: FakeLib)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.call("fst_rbgs_half", ctypes.c_void_p(0))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler is a hard error at first use, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_sources_and_sign_mask():
    names = {s.name for s in _build.sources()}
    assert {"rbgs.cu", "project.cu", "advect_split.cu", "pad_bounds.cu",
            "common.cuh"} <= names
    assert len(_build.source_hash()) == 16
    # field 0 x-negated, field 1 y-negated, field 2 z-negated
    assert _build.neg_mask([(-1.0, 1.0, 1.0), (1.0, -1.0, 1.0),
                            (1.0, 1.0, -1.0)]) == 0b100_010_001
