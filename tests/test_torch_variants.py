"""The last three single-card kernel variants, their plain torch versions
against the JAX Pallas kernels run as the JAX suite runs them on the CPU
(``interpret=True``):

- kernel 5, the fused three-field solve (``kernels.linsolve.rbgs_solve3``
  vs ``pallas_rbgs_solve3``);
- kernel 1 unpacked (``rbgs_solve(..., packed=False)``, whose plain version
  is ``rbgs_solve_plain`` with the padded keep, vs
  ``pallas_rbgs_solve(packed=False)``);
- kernel 8, the fused-backtrace split advection
  (``kernels.advect_split.advect_split_fused`` vs ``advect_split_fused``).

Tolerances. The solves are held to 1e-6 on O(1) values, the bound of
tests/test_torch_kernels.py for kernel 1: the interpreter contracts
``prev + a*s`` into a fused multiply-add, torch rounds each operation on its
own. Kernel 8's plain version is bitwise equal to the JAX suite's
uncontracted NumPy oracle (``advect_split_reference``), and the JAX fused
passes are bitwise equal to its lane passes here; so the port is held to the
JAX fused passes with the JAX suite's own bounds for its split kernel
against that oracle: 1e-5 (tests/test_advect_split.py:56) and, on the
140-wide grid, 1e-4 (:121). There the interpreter's contracted backtrace
moves a coordinate near 140 by an ulp (1.5e-5), which moves the lerp weight
by as much (measured max 2.7e-5; 4.6e-6 and 2.2e-6 on the narrow grids).
Within the port the three-field solve is bitwise three single-field solves,
as the JAX suite asserts for its kernels (tests/test_kernels.py:58-82).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.advect_pallas import (
    advect_split_fused as jax_advect_split_fused, advect_split_reference)
from fluid_simulation_tpu.kernels.linsolve_pallas import (
    pallas_rbgs_solve, pallas_rbgs_solve3)
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.kernels.advect_split import (
    advect_split_fused, advect_split_plain)
from fluid_simulation_tpu_torch.kernels.linsolve import (
    rbgs_solve, rbgs_solve3, rbgs_solve3_plain, rbgs_solve_plain)

torch.set_num_threads(1)

SOLVE_ATOL = 1e-6
W, H, D = 16, 8, 8
PAD = (D + 2, H + 2, W + 2)


def _fields(n, seed, shape=PAD):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _sphere_keep_vel():
    """keep_vel of the JAX suite's solver scene (tests/test_kernels.py:21-27):
    1 on the ghost shell, as every mask from build_masks is."""
    obs = add_sphere(empty_obstacles(W, H, D), W // 3, H // 2, D // 2, 2.5)
    return np.asarray(jax_build_masks(jnp.asarray(obs)).keep_vel)


@pytest.mark.parametrize("empty,wall_mode", [
    (False, "reference"), (True, "reference"), (False, "noslip")])
def test_k5_solve3_matches_pallas(empty, wall_mode):
    """The three cases of tests/test_kernels.py:58-60."""
    fs, ps = _fields(3, 30), _fields(3, 31)
    keep = None if empty else _sphere_keep_vel()
    want = pallas_rbgs_solve3(
        (1, 2, 3), *map(jnp.asarray, fs + ps),
        None if keep is None else jnp.asarray(keep), 1.0, 6.0, acc=5,
        wall_mode=wall_mode, interpret=True, empty_scene=empty)
    args = [_t(x) for x in fs + ps]
    tkeep = None if keep is None else _t(keep)
    got = rbgs_solve3_plain((1, 2, 3), *args, 1.0, 6.0, 5, wall_mode, tkeep)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=SOLVE_ATOL)
    # the wrapper (plain on the CPU) is three single-field solves, bitwise
    wrapped = rbgs_solve3((1, 2, 3), *args, 1.0, 6.0, 5, wall_mode, tkeep)
    for b, g, f, p in zip((1, 2, 3), wrapped, args[:3], args[3:]):
        assert torch.equal(g, rbgs_solve(b, f, p, 1.0, 6.0, 5, wall_mode,
                                         tkeep))


def _ghost_zero_keep(seed=40):
    """A random 0/1 padded keep with zeros on ghost faces, edges and corners:
    where the packed and the unpacked solve differ."""
    rng = np.random.default_rng(seed)
    keep = (rng.uniform(size=PAD) > 0.2).astype(np.float32)
    keep[0, 0, :] = keep[-1, :, 0] = keep[:, -1, -1] = 0.0   # edges
    keep[0, 0, 0] = keep[-1, -1, -1] = 0.0                   # corners
    keep[1:-1, 1:-1, 0] = keep[1:-1, 1:-1, 0] * (rng.uniform(
        size=(D, H)) > 0.5)                                   # x- face
    return keep


@pytest.mark.parametrize("b,wall_mode", [(0, "reference"), (1, "reference"),
                                         (3, "noslip")])
def test_k1_unpacked_matches_pallas_on_ghost_keeps(b, wall_mode):
    f, g = _fields(2, 41 + b)
    keep = _ghost_zero_keep()
    assert (keep[0] == 0).any() and keep[0, 0, 0] == 0
    want = pallas_rbgs_solve(b, jnp.asarray(f), jnp.asarray(g),
                             jnp.asarray(keep), 0.7, 5.2, acc=6,
                             wall_mode=wall_mode, interpret=True, packed=False)
    got = rbgs_solve_plain(b, _t(f), _t(g), 0.7, 5.2, 6, wall_mode, _t(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SOLVE_ATOL)
    assert torch.equal(rbgs_solve(b, _t(f), _t(g), 0.7, 5.2, 6, wall_mode,
                                  _t(keep), packed=False), got)
    # the packed kernel assumes keep = 1 on the ghost shell: here it differs
    packed = np.asarray(pallas_rbgs_solve(
        b, jnp.asarray(f), jnp.asarray(g), jnp.asarray(keep), 0.7, 5.2,
        acc=6, wall_mode=wall_mode, interpret=True, packed=True))
    assert np.abs(packed - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("b", [0, 2])
def test_k1_unpacked_equals_packed_on_scene_keeps(b):
    """With a keep from build_masks (1 on the ghost shell) the packed and the
    unpacked kernel and the plain version agree."""
    f, g = _fields(2, 50 + b)
    keep = jnp.asarray(_sphere_keep_vel())
    kw = dict(acc=6, interpret=True)
    unpacked = np.asarray(pallas_rbgs_solve(b, jnp.asarray(f), jnp.asarray(g),
                                            keep, 0.7, 5.2, packed=False,
                                            **kw))
    packed = np.asarray(pallas_rbgs_solve(b, jnp.asarray(f), jnp.asarray(g),
                                          keep, 0.7, 5.2, packed=True, **kw))
    np.testing.assert_array_equal(packed, unpacked)
    got = rbgs_solve_plain(b, _t(f), _t(g), 0.7, 5.2, 6, keep=_t(keep))
    np.testing.assert_allclose(got.numpy(), unpacked, rtol=0,
                               atol=SOLVE_ATOL)


def _advect_inputs(dims, seed):
    """tests/test_advect_split.py:15-23's fields."""
    Wd, Hd, Dd = dims
    shape = (Dd + 2, Hd + 2, Wd + 2)
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=shape).astype(np.float32)
    vx = rng.uniform(-20, 25, size=shape).astype(np.float32)
    vy = rng.uniform(-3, 3, size=shape).astype(np.float32)
    vz = rng.uniform(-3, 3, size=shape).astype(np.float32)
    return prev, vx, vy, vz


@pytest.mark.parametrize("dims,seed,tol", [((24, 12, 10), 0, 1e-5),
                                           ((140, 10, 8), 5, 1e-4),
                                           ((18, 8, 6), 2, 1e-5)])
def test_k8_advect_split_fused_matches_pallas(dims, seed, tol):
    """The dims of tests/test_advect_split.py:124-138, a stack of three."""
    prev, vx, vy, vz = _advect_inputs(dims, seed)
    stacked = np.stack([prev, prev * 0.5 + 0.1, prev * -0.25])
    want = np.asarray(jax_advect_split_fused(
        jnp.asarray(stacked), *map(jnp.asarray, (vx, vy, vz)), 0.05,
        interpret=True))
    vel = [_t(v) for v in (vx, vy, vz)]
    got = advect_split_fused(_t(stacked), *vel, 0.05)
    Wd, Hd, Dd = dims
    assert got.shape == want.shape == (3, Dd, Hd, Wd)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert torch.equal(got, advect_split_plain(_t(stacked), *vel, 0.05))
    for g, field in zip(got.numpy(), stacked):
        np.testing.assert_array_equal(
            g, advect_split_reference(field, vx, vy, vz, 0.05))
