"""Each kernel module's plain torch version against the JAX Pallas kernel it
ports, the latter run as the JAX suite runs it on the CPU
(``interpret=True``). The CUDA kernels themselves are held to these plain
versions on the card by ``chip_smoke.py``.

Tolerances. Torch rounds every product and sum on its own; XLA's CPU
compiler and the Pallas interpreter contract some ``a*b + c`` into fused
multiply-adds. So K1 and K2 agree to 1e-6 on O(1) values, the JAX suite's
own interpret-vs-XLA bound for these kernels (tests/test_kernels.py:118-119;
measured max 2.4e-7). K3 agrees to 1e-5, the JAX suite's bound for its split
kernel against the NumPy oracle (tests/test_advect_split.py:56; measured
max 4.6e-6 after three chained lerps), and is bitwise equal to that
uncontracted NumPy oracle. K4 only moves data and exact signs: bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.advect_pallas import (
    advect_split_reference, advect_split_t)
from fluid_simulation_tpu.kernels.bounds_pallas import pallas_pad_bounds
from fluid_simulation_tpu.kernels.linsolve_pallas import pallas_rbgs_solve
from fluid_simulation_tpu.kernels.project_pallas import pallas_project_empty
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.kernels.advect_split import advect_split_plain
from fluid_simulation_tpu_torch.kernels.bounds import pad_bounds_plain
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve_plain
from fluid_simulation_tpu_torch.kernels.project import project_empty_plain
from fluid_simulation_tpu_torch.ops.project import project
from fluid_simulation_tpu_torch.scene.masks import build_masks

torch.set_num_threads(1)

W, H, D = 16, 8, 8


def _fields(n, seed, shape=(D + 2, H + 2, W + 2)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,wall_mode,acc", [
    (0, "reference", 6), (1, "reference", 6), (2, "noslip", 6),
    (3, "reference", 1)])
def test_k1_rbgs_solve_matches_pallas(b, wall_mode, acc):
    """K1 on arbitrary input ghosts (sweep 1 reads the caller's faces)."""
    f, g = _fields(2, b)
    want = pallas_rbgs_solve(b, jnp.asarray(f), jnp.asarray(g), None, 0.7,
                             5.2, acc=acc, wall_mode=wall_mode,
                             interpret=True, empty_scene=True, packed=True)
    got = rbgs_solve_plain(b, _t(f), _t(g), 0.7, 5.2, acc, wall_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_k2_project_empty_matches_pallas(wall_mode):
    vel = _fields(3, 21)
    want = pallas_project_empty(*map(jnp.asarray, vel), acc=6,
                                wall_mode=wall_mode, interpret=True)
    got = project_empty_plain(*map(_t, vel), acc=6, wall_mode=wall_mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_k2_plain_equals_composable_project(wall_mode):
    """The select form equals ops.project on an empty scene."""
    vel = [_t(v) for v in _fields(3, 22)]
    masks = build_masks(empty_obstacles(W, H, D))
    want = project(*vel, masks, acc=5, wall_mode=wall_mode, empty_scene=True)
    got = project_empty_plain(*vel, acc=5, wall_mode=wall_mode)
    for a, b in zip(got, want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _advect_inputs(dims, seed):
    Wd, Hd, Dd = dims
    shape = (Dd + 2, Hd + 2, Wd + 2)
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=shape).astype(np.float32)
    vx = rng.uniform(-20, 25, size=shape).astype(np.float32)
    vy = rng.uniform(-3, 3, size=shape).astype(np.float32)
    vz = rng.uniform(-3, 3, size=shape).astype(np.float32)
    return prev, vx, vy, vz


@pytest.mark.parametrize("dims,seed", [((24, 12, 10), 0), ((18, 8, 6), 2)])
@pytest.mark.parametrize("stack", [1, 3])
def test_k3_advect_split_matches_pallas(dims, seed, stack):
    prev, vx, vy, vz = _advect_inputs(dims, seed)
    if stack == 3:
        prev = np.stack([prev, prev * 0.5 + 0.1, prev * -0.25])
    want = advect_split_t(jnp.asarray(prev), *map(jnp.asarray, (vx, vy, vz)),
                          0.05, interpret=True)
    got = advect_split_plain(_t(prev), *map(_t, (vx, vy, vz)), 0.05)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dims,seed", [((24, 12, 10), 0), ((130, 10, 8), 3)])
def test_k3_plain_equals_numpy_oracle(dims, seed):
    """No contraction on either side: bitwise, including a 132-wide x axis."""
    prev, vx, vy, vz = _advect_inputs(dims, seed)
    want = advect_split_reference(prev, vx, vy, vz, 0.05)
    got = advect_split_plain(*map(_t, (prev, vx, vy, vz)), 0.05)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs,wall_mode,masked", [
    ((1, 2, 3), "reference", False),
    ((1, 2, 3), "noslip", False),
    ((0,), "reference", False),
    ((1, 2, 3), "reference", True),
    ((0,), "reference", True),
])
def test_k4_pad_bounds_matches_pallas(bs, wall_mode, masked):
    rng = np.random.default_rng(11)
    smp = rng.normal(size=(len(bs), D, H, W)).astype(np.float32)
    jkw, tkw = {}, {}
    if masked:
        obs = add_sphere(empty_obstacles(W, H, D), W // 3, H // 2, D // 2, 2.5)
        jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs)
        jkeep = jm.keep_vel if bs[0] else jm.keep_scalar
        tkeep = tm.keep_vel if bs[0] else tm.keep_scalar
        jkw = dict(fluid_i=jm.fluid_i, keep_i=jkeep[1:-1, 1:-1, 1:-1])
        tkw = dict(fluid_i=tm.fluid_i, keep_i=tkeep[1:-1, 1:-1, 1:-1])
    want = pallas_pad_bounds(jnp.asarray(smp), bs, wall_mode, interpret=True,
                             **jkw)
    got = pad_bounds_plain(_t(smp), bs, wall_mode, **tkw)
    assert len(got) == len(bs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
