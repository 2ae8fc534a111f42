"""The PyTorch port's ops against the JAX package's ops on the CPU.

Same inputs, made from a NumPy seed, go through both packages at a small
grid, with and without a sphere. Tolerances: masks, boundaries, projection
and advection agree bitwise on these inputs (both compute every op with
one rounding and the same operand order). The linear solver's update
``(prev + a*s) * (1/c)`` is contracted into a fused multiply-add by XLA's
CPU compiler and not by torch, so it agrees to 1e-6 absolute on O(1)
values (measured max 1.2e-7); with ``a = 1`` (the projection) there is
nothing to contract.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.scene.masks import build_masks

torch.set_num_threads(1)

CPU = "cpu"

W, H, D = 24, 12, 10
SHAPE = (D + 2, H + 2, W + 2)
SCENES = ["empty", "sphere"]


def _ops(pkg, name):
    return importlib.import_module(f"{pkg}.ops.{name}")


def _scene(scene):
    obs = empty_obstacles(W, H, D)
    if scene == "sphere":
        obs = add_sphere(obs, 8, 6, 5, 3)
    return obs, jax_build_masks(jnp.asarray(obs)), build_masks(obs, device=CPU)


def _fields(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=SHAPE) * scale).astype(np.float32)
            for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scene", SCENES)
def test_masks_match_jax(scene):
    _, jm, tm = _scene(scene)
    assert tm._fields == jm._fields
    for name, a, b in zip(tm._fields, tm, jm):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("scene", SCENES)
def test_set_bounds_matches_jax(scene, wall_mode):
    _, jm, tm = _scene(scene)
    jb, tb = _ops("fluid_simulation_tpu", "bounds"), _ops(
        "fluid_simulation_tpu_torch", "bounds")
    f, = _fields(1, 3)
    for b in (0, 1, 2, 3):
        got = tb.set_bounds(b, _t(f), tm, wall_mode, scene == "empty")
        want = jb.set_bounds(b, jnp.asarray(f), jm, wall_mode,
                             scene == "empty")
        _equal(got, want)


@pytest.mark.parametrize("solver", ["jacobi", "rbgs", "gs_wavefront"])
@pytest.mark.parametrize("scene", SCENES)
def test_linear_solver_matches_jax(scene, solver):
    _, jm, tm = _scene(scene)
    jl, tl = _ops("fluid_simulation_tpu", "linsolve"), _ops(
        "fluid_simulation_tpu_torch", "linsolve")
    f, g = _fields(2, 5)
    for b, wall in ((0, "reference"), (1, "reference"), (3, "noslip")):
        want = jl.linear_solver(b, jnp.asarray(f), jnp.asarray(g), 0.3, 2.8,
                                jm, acc=4, solver=solver, wall_mode=wall,
                                empty_scene=scene == "empty")
        src = _t(f)
        got = tl.linear_solver(b, src, _t(g), 0.3, 2.8, tm, acc=4,
                               solver=solver, wall_mode=wall,
                               empty_scene=scene == "empty")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=f"b={b}")
        np.testing.assert_array_equal(src.numpy(), f)   # input untouched


def test_diffusion_coeffs_match_jax():
    jl, tl = _ops("fluid_simulation_tpu", "linsolve"), _ops(
        "fluid_simulation_tpu_torch", "linsolve")
    for args in ((128, 64, 64, 0.05, 2e-5), (24, 12, 10, 0.05, 1.5e-5)):
        assert tl.diffusion_coeffs(*args) == jl.diffusion_coeffs(*args)


@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("scene", SCENES)
def test_project_matches_jax(scene, wall_mode):
    _, jm, tm = _scene(scene)
    jp, tp = _ops("fluid_simulation_tpu", "project"), _ops(
        "fluid_simulation_tpu_torch", "project")
    vel = _fields(3, 7)
    want = jp.project(*map(jnp.asarray, vel), jm, acc=5, solver="rbgs",
                      wall_mode=wall_mode, empty_scene=scene == "empty")
    got = tp.project(*map(_t, vel), tm, acc=5, solver="rbgs",
                     wall_mode=wall_mode, empty_scene=scene == "empty")
    for name, a, b in zip(("vx", "vy", "vz", "p", "div"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("scene", SCENES)
def test_compat_advect_matches_jax(scene):
    """The compat chain: component b backtraces with ``prev``."""
    _, jm, tm = _scene(scene)
    ja, ta = _ops("fluid_simulation_tpu", "advect"), _ops(
        "fluid_simulation_tpu_torch", "advect")
    prev, vx, vy, vz = _fields(4, 9)
    vx = vx * 10 + 5   # backtraces several cells long
    for b in (0, 1, 2, 3):
        want = ja.advect(b, jnp.asarray(prev), *map(jnp.asarray, (vx, vy, vz)),
                         jm, 0.05, empty_scene=scene == "empty")
        got = ta.advect(b, _t(prev), *map(_t, (vx, vy, vz)), tm, 0.05,
                        empty_scene=scene == "empty")
        _equal(got, want)


def test_trilinear_gather_matches_jax():
    ja, ta = _ops("fluid_simulation_tpu", "advect"), _ops(
        "fluid_simulation_tpu_torch", "advect")
    prev, = _fields(1, 11)
    rng = np.random.default_rng(12)
    # clamped coordinates, ends of the range included
    xb, yb, zb = (rng.uniform(0.5, n + 0.5, size=(D, H, W)).astype(np.float32)
                  for n in (W, H, D))
    xb[0, 0, 0], yb[0, 0, 0], zb[0, 0, 0] = W + 0.5, H + 0.5, D + 0.5
    want = ja.trilinear_gather(jnp.asarray(prev), *map(jnp.asarray,
                                                        (xb, yb, zb)))
    got = ta.trilinear_gather(_t(prev), *map(_t, (xb, yb, zb)))
    _equal(got, want)


@pytest.mark.parametrize("scene", SCENES)
def test_vorticity_matches_jax(scene):
    _, jm, tm = _scene(scene)
    jv, tv = _ops("fluid_simulation_tpu", "vorticity"), _ops(
        "fluid_simulation_tpu_torch", "vorticity")
    vel = _fields(3, 13)
    want = jv.apply_confinement(*map(jnp.asarray, vel), jm, 5.0, 0.05)
    got = tv.apply_confinement(*map(_t, vel), tm, 5.0, 0.05)
    for a, b in zip(got, want):
        # sqrt and division may round differently between the two CPU
        # back ends: a few ulp of the O(1) field
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
