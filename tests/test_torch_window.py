"""Compat and fast advection with ``advect_window > 0``: the port's
trilinear gather (kernel 9's plain version, ``ops.advect.trilinear_gather``,
which ``kernels.advect_compat.trilinear_gather_window`` takes on the CPU)
against the JAX corner-fetch path run as the JAX suite runs it on the CPU
(``trilinear_gather_pallas(..., interpret=True)``), and whole windowed steps
against the JAX step.

Tolerances. The gather is held to 5e-7, the JAX suite's own bound for its
corner fetch + lerp against the XLA gather (tests/test_advect_compat.py:108,
:139): the interpreter contracts the lerp into fused multiply-adds, torch
rounds each product on its own. Whole steps from a random state are held to
the bounds of tests/test_torch_step.py (5e-5 of the field maximum after step
1, 2.5e-3 after step 2, and the step-2 bound again after step 3; measured at
16x8x8 with a window of 1: at most 2.1e-6, 3.9e-5 and 8.4e-5). With the
window or without it the port's step is bitwise the same on the CPU, the
counterpart of the JAX suite's test_advect_window_param_wiring.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.config import SimParams as JaxSimParams
from fluid_simulation_tpu.kernels.advect_compat import trilinear_gather_pallas
from fluid_simulation_tpu.models import windtunnel as jwt
from fluid_simulation_tpu.ops.advect import backtrace as jax_backtrace
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
from fluid_simulation_tpu_torch.kernels.advect_compat import (
    trilinear_gather_window)
from fluid_simulation_tpu_torch.ops.advect import trilinear_gather

torch.set_num_threads(1)

CPU = "cpu"
GATHER_ATOL = 5e-7
STEP_BOUNDS = (5e-5, 2.5e-3, 2.5e-3)   # relative to the field maximum


def _gather_case(shape, vmag_y, vmag_z, seed):
    """A padded field and backtraced coordinates whose y/z offsets are
    bounded by dt*N*vmag, made as tests/test_advect_compat.py makes them."""
    D2, H2, W2 = shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=shape).astype(np.float32)
    vx = rng.normal(scale=2.0, size=(D, H, W)).astype(np.float32)
    vy = rng.normal(scale=vmag_y, size=(D, H, W)).astype(np.float32)
    vz = rng.normal(scale=vmag_z, size=(D, H, W)).astype(np.float32)
    coords = jax_backtrace(*map(jnp.asarray, (vx, vy, vz)), 0.05, W, H, D,
                           jnp.float32)
    return prev, [np.array(c) for c in coords]


def _offsets(coords, shape):
    """Largest |floor(zb) - z| and |floor(yb) - y| of the backtrace."""
    D, H = shape[0] - 2, shape[1] - 2
    _, yb, zb = coords
    dy = np.floor(yb) - np.arange(1, H + 1)[None, :, None]
    dz = np.floor(zb) - np.arange(1, D + 1)[:, None, None]
    return int(np.abs(dz).max()), int(np.abs(dy).max())


def _check_gather(shape, prev, coords):
    want = np.asarray(trilinear_gather_pallas(
        jnp.asarray(prev), *map(jnp.asarray, coords), K=1, KY=1,
        interpret=True))
    args = (torch.from_numpy(prev), *map(torch.from_numpy, coords))
    got = trilinear_gather(*args)
    assert got.shape == want.shape == tuple(n - 2 for n in shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GATHER_ATOL)
    # the wrapper takes the plain version for a tensor on the CPU
    assert torch.equal(trilinear_gather_window(*args), got)


@pytest.mark.parametrize("shape", [(10, 18, 34), (8, 10, 130), (6, 10, 162)])
def test_k9_gather_in_window_matches_pallas(shape):
    """Backtraces inside the kernel's window (offsets <= 1): the JAX side
    runs its corner-fetch kernel; single-window, flagship-width and chunked
    geometries, as tests/test_advect_compat.py:80-85."""
    D2, H2, _ = shape
    prev, coords = _gather_case(shape, 2.0 / H2, 2.0 / D2, seed=5)
    assert max(_offsets(coords, shape)) <= 1
    _check_gather(shape, prev, coords)


@pytest.mark.parametrize("vmag,least", [(2.0, 2), (12.0, 10)])
def test_k9_gather_past_the_window_matches_pallas(vmag, least):
    """Backtraces that leave the window (the JAX side falls back to its XLA
    gather, tests/test_advect_compat.py:128-139), up to 10+ cells."""
    shape = (10, 18, 34)
    prev, coords = _gather_case(shape, vmag, vmag, seed=7)
    assert max(_offsets(coords, shape)) >= least
    _check_gather(shape, prev, coords)


def _random_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    vel = [rng.uniform(-3, 3, size=shape).astype(np.float32)
           for _ in range(3)]
    vel[0] += 20
    return vel + [rng.uniform(0, 0.01, size=shape).astype(np.float32)]


W, H, D = 16, 8, 8


def _obstacles(scene):
    obs = empty_obstacles(W, H, D)
    return add_sphere(obs, 5, 4, 4, 2) if scene == "sphere" else obs


@pytest.mark.parametrize("mode,scene", [
    ("compat", "empty"), ("compat", "sphere"), ("fast", "empty")])
def test_window_step_matches_jax(mode, scene):
    kw = dict(width=W, height=H, depth=D, mode=mode, acc=8, advect_window=1)
    obs = _obstacles(scene)
    jt = jwt.WindTunnel(JaxSimParams(**kw), obstacles=obs)
    tt = WindTunnel(SimParams(**kw), obstacles=obs, device=CPU)
    fields = _random_fields(jt.params.padded_shape)
    jt.state = jwt.FluidState(*map(jnp.asarray, fields))
    tt.state = state_from_numpy(fields, device=CPU)
    for step, bound in enumerate(STEP_BOUNDS, 1):
        jt.step()
        tt.step()
        for name, got, want in zip(("vx", "vy", "vz", "dens"),
                                   state_to_numpy(tt.state), jt.state):
            want = np.asarray(want)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < bound, f"step {step} {name}: {err:.3g}"


@pytest.mark.parametrize("mode", ["compat", "fast", "split"])
@pytest.mark.parametrize("scene", ["empty", "sphere"])
def test_window_changes_no_value(mode, scene):
    """A window of 1 and none give the same bits over 3 steps (split
    ignores the window, as the JAX package does)."""
    finals = []
    for window in (0, 1):
        p = SimParams(width=W, height=H, depth=D, acc=6, mode=mode,
                      advect_window=window)
        wt = WindTunnel(p, obstacles=_obstacles(scene), device=CPU)
        wt.state = state_from_numpy(_random_fields(p.padded_shape, seed=2),
                                    device=CPU)
        wt.simulate(3)
        finals.append(wt.state)
    for a, b in zip(*finals):
        assert torch.equal(a, b)
