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
uncontracted NumPy oracle. K4 only moves data, exact signs and 0/1 mask
products: bitwise. K19's plain version, a whole compat advect, is held
bitwise to the JAX package's compat advect (its XLA backtrace, gather and
setBounds, the stages the kernel fuses), as tests/test_torch_ops.py holds
the composable op; K20's, fast's shared backtrace and three velocity
samples, bitwise to the JAX package's fast sampling (its XLA backtrace,
three XLA gathers and the stack). The obstacle forms (K1 keep, K6) and K10 are held to the
same bounds as their empty-scene kernels; each is also bitwise equal to the
port's composable ops, which the card's plain versions repeat.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.advect_pallas import (
    advect_split_reference, advect_split_t)
from fluid_simulation_tpu.kernels.bounds_pallas import pallas_pad_bounds
from fluid_simulation_tpu.kernels.linsolve_pallas import pallas_rbgs_solve
from fluid_simulation_tpu.kernels.project_pallas import (
    pallas_project_empty, pallas_project_masked)
from fluid_simulation_tpu.kernels.vorticity_pallas import pallas_confinement
from fluid_simulation_tpu.ops.advect import advect as jax_advect
from fluid_simulation_tpu.ops.advect import backtrace as jax_backtrace
from fluid_simulation_tpu.ops.advect import (
    trilinear_gather as jax_trilinear_gather)
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.kernels.advect_compat import (
    advect_compat, advect_compat_plain)
from fluid_simulation_tpu_torch.kernels.advect_fast import (
    advect_fast, advect_fast_plain)
from fluid_simulation_tpu_torch.kernels.advect_split import advect_split_plain
from fluid_simulation_tpu_torch.kernels.bounds import pad_bounds_plain
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve_plain
from fluid_simulation_tpu_torch.kernels.project import (
    project_empty_plain, project_masked_plain)
from fluid_simulation_tpu_torch.kernels.vorticity import confinement_plain
from fluid_simulation_tpu_torch.ops.project import project
from fluid_simulation_tpu_torch.ops.vorticity import apply_confinement
from fluid_simulation_tpu_torch.scene.masks import build_masks

torch.set_num_threads(1)

CPU = "cpu"

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
    masks = build_masks(empty_obstacles(W, H, D), device=CPU)
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


# ragged (D, H, W): one-cell grids, and x extents that fill no whole chunk
# of the card kernel's lanes (W + 2 = 3, 9, 132 and 602)
RAGGED_PAD = ((1, 1, 1), (3, 5, 7), (5, 3, 130), (2, 3, 600))


def _k4_cases():
    cases = [pytest.param(bs, wall, masked, (D, H, W), id=f"bs{i}-{wall}-"
                          f"{masked}")
             for i, (bs, wall, masked) in enumerate([
                 ((1, 2, 3), "reference", False),
                 ((1, 2, 3), "noslip", False),
                 ((0,), "reference", False),
                 ((1, 2, 3), "reference", True),
                 ((0,), "reference", True)])]
    for dims in RAGGED_PAD:
        for bs, wall, masked in (((1, 2, 3), "noslip", False),
                                 ((2, 3), "reference", False),
                                 ((1, 2, 3), "reference", True),
                                 ((0,), "noslip", True)):
            cases.append(pytest.param(
                bs, wall, masked, dims, id="ragged{}x{}x{}-b{}-{}-{}".format(
                    *dims, len(bs), wall, "masked" if masked else "plain")))
    return cases


@pytest.mark.parametrize("bs,wall_mode,masked,dhw", _k4_cases())
def test_k4_pad_bounds_matches_pallas(bs, wall_mode, masked, dhw):
    Dd, Hd, Wd = dhw
    rng = np.random.default_rng(11)
    smp = rng.normal(size=(len(bs), Dd, Hd, Wd)).astype(np.float32)
    jkw, tkw = {}, {}
    if masked:
        if dhw == (D, H, W):
            obs = add_sphere(empty_obstacles(W, H, D), W // 3, H // 2, D // 2,
                             2.5)
        else:
            obs = _obstacle_scene("random", (Wd, Hd, Dd))
        jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs, device=CPU)
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


# -- obstacle scenes and vorticity (K1 keep, K6, K4 masked, K10) ----------

def _obstacle_scene(kind, dims):
    """A padded obstacle field: the sphere, or a random 0/1 field (seeded)
    with an odd grid."""
    Wd, Hd, Dd = dims
    if kind == "sphere":
        return add_sphere(empty_obstacles(Wd, Hd, Dd), Wd // 3, Hd // 2,
                          Dd // 2, 2.5)
    rng = np.random.default_rng(17)
    obs = empty_obstacles(Wd, Hd, Dd)
    obs[1:-1, 1:-1, 1:-1] = (rng.uniform(size=(Dd, Hd, Wd)) < 0.2)
    return obs


SCENES = [("sphere", (W, H, D)), ("random", (13, 7, 5))]


def _both_masks(kind, dims):
    obs = _obstacle_scene(kind, dims)
    return jax_build_masks(jnp.asarray(obs)), build_masks(obs, device=CPU)


def _padded(dims):
    Wd, Hd, Dd = dims
    return (Dd + 2, Hd + 2, Wd + 2)


@pytest.mark.parametrize("kind,dims", SCENES)
@pytest.mark.parametrize("b,wall_mode", [(0, "reference"), (1, "reference"),
                                         (2, "noslip"), (3, "noslip")])
def test_k1_keep_matches_pallas(kind, dims, b, wall_mode):
    """K1's keep form on arbitrary input ghosts and solid cells."""
    jm, tm = _both_masks(kind, dims)
    jkeep = jm.keep_vel if b else jm.keep_scalar
    tkeep = tm.keep_vel if b else tm.keep_scalar
    f, g = _fields(2, 30 + b, _padded(dims))
    want = pallas_rbgs_solve(b, jnp.asarray(f), jnp.asarray(g), jkeep, 0.7,
                             5.2, acc=6, wall_mode=wall_mode, interpret=True,
                             empty_scene=False, packed=True)
    got = rbgs_solve_plain(b, _t(f), _t(g), 0.7, 5.2, 6, wall_mode, tkeep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind,dims", SCENES)
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_k6_project_masked_matches_pallas(kind, dims, wall_mode):
    jm, tm = _both_masks(kind, dims)
    vel = _fields(3, 41, _padded(dims))
    want = pallas_project_masked(*map(jnp.asarray, vel), jm.fluid_i,
                                 jm.keep_vel[1:-1, 1:-1, 1:-1], acc=6,
                                 wall_mode=wall_mode, interpret=True)
    got = project_masked_plain(*map(_t, vel), tm.fluid_i,
                               tm.keep_vel[1:-1, 1:-1, 1:-1], acc=6,
                               wall_mode=wall_mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kind,dims", SCENES)
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_k6_plain_equals_composable_project(kind, dims, wall_mode):
    """The kernel's arithmetic form equals ops.project on obstacle scenes
    (the wrapper's plain path and the step's plain path agree)."""
    _, tm = _both_masks(kind, dims)
    vel = [_t(v) for v in _fields(3, 42, _padded(dims))]
    want = project(*vel, tm, acc=5, wall_mode=wall_mode)
    got = project_masked_plain(*vel, tm.fluid_i,
                               tm.keep_vel[1:-1, 1:-1, 1:-1], acc=5,
                               wall_mode=wall_mode)
    for a, b in zip(got, want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind,dims", SCENES)
@pytest.mark.parametrize("bs,wall_mode", [((1, 2, 3), "noslip"),
                                          ((0,), "noslip")])
def test_k4_masked_matches_pallas(kind, dims, bs, wall_mode):
    jm, tm = _both_masks(kind, dims)
    Wd, Hd, Dd = dims
    rng = np.random.default_rng(12)
    smp = rng.normal(size=(len(bs), Dd, Hd, Wd)).astype(np.float32)
    jkeep = jm.keep_vel if bs[0] else jm.keep_scalar
    tkeep = tm.keep_vel if bs[0] else tm.keep_scalar
    want = pallas_pad_bounds(jnp.asarray(smp), bs, wall_mode,
                             fluid_i=jm.fluid_i,
                             keep_i=jkeep[1:-1, 1:-1, 1:-1], interpret=True)
    got = pad_bounds_plain(_t(smp), bs, wall_mode, fluid_i=tm.fluid_i,
                           keep_i=tkeep[1:-1, 1:-1, 1:-1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind,dims", SCENES + [("empty", (W, H, D))])
def test_k10_confinement_matches_pallas(kind, dims):
    if kind == "empty":
        obs = empty_obstacles(*dims)
        jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs,
                                                                device=CPU)
    else:
        jm, tm = _both_masks(kind, dims)
    vel = _fields(3, 43, _padded(dims))
    want = pallas_confinement(*map(jnp.asarray, vel),
                              jm.keep_vel[1:-1, 1:-1, 1:-1], 5.0, 0.05,
                              interpret=True)
    got = confinement_plain(*map(_t, vel), tm.keep_vel[1:-1, 1:-1, 1:-1],
                            5.0, 0.05)
    # sqrt and division may round differently between the two CPU back
    # ends (as tests/test_torch_ops.py's vorticity bound): a few ulp
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    # and bitwise to the port's composable op, which the step's plain path
    # runs
    for a, b in zip(got, apply_confinement(*map(_t, vel), tm, 5.0, 0.05)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- compat advection in one launch (K19) ---------------------------------

@pytest.mark.parametrize("kind,dims", SCENES + [("empty", (W, H, D))])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_k19_plain_matches_jax_advect(kind, dims, b, wall_mode):
    """K19's plain version (and its wrapper on a CPU tensor) against the
    JAX package's compat advect, from velocities whose backtraces clamp at
    every face and, where a velocity is zero, land on exact integers."""
    empty = kind == "empty"
    if empty:
        obs = empty_obstacles(*dims)
        jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs,
                                                                device=CPU)
    else:
        jm, tm = _both_masks(kind, dims)
    prev, vx, vy, vz = _fields(4, 50 + b, _padded(dims))
    rng = np.random.default_rng(51 + b)
    still = rng.uniform(size=vx.shape) < 0.25
    vx, vy, vz = (np.where(still, 0.0, v * 12).astype(np.float32)
                  for v in (vx, vy, vz))
    want = jax_advect(b, *map(jnp.asarray, (prev, vx, vy, vz)), jm, 0.1,
                      wall_mode, empty)
    args = (b, *map(_t, (prev, vx, vy, vz)), tm, 0.1, wall_mode, empty)
    got = advect_compat_plain(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(advect_compat(*args), got)


# -- fast advection's velocity in one launch (K20) ------------------------

@pytest.mark.parametrize("dims", [(W, H, D), (13, 7, 5), (37, 3, 2)])
@pytest.mark.parametrize("reach", [12.0, 0.5])
def test_k20_plain_matches_jax_fast_sampling(dims, reach):
    """K20's plain version (and its wrapper on CPU tensors, the step's
    interior views) against the JAX fast step's sampling: its backtrace
    through the velocity interiors, then each save gathered there and
    stacked (fluid_simulation_tpu/models/windtunnel.py:339-355). Velocities
    up to 12 cells' worth clamp at every face; a quarter are zero, so
    those backtraces land on exact integers."""
    Wd, Hd, Dd = dims
    saves = _fields(3, 60 + Wd, _padded(dims))
    vel = _fields(3, 61 + Wd, _padded(dims))
    rng = np.random.default_rng(62 + Wd)
    still = rng.uniform(size=vel[0].shape) < 0.25
    vel = [np.where(still, 0.0, v * reach).astype(np.float32) for v in vel]
    inner = (slice(1, -1),) * 3
    coords = jax_backtrace(*(jnp.asarray(v[inner]) for v in vel), 0.1, Wd,
                           Hd, Dd, jnp.float32)
    want = jnp.stack([jax_trilinear_gather(jnp.asarray(f), *coords)
                      for f in saves])
    views = [_t(v)[inner] for v in vel]
    got = advect_fast_plain(*views, [_t(f) for f in saves], 0.1)
    assert got.shape == (3, Dd, Hd, Wd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(advect_fast(*views, [_t(f) for f in saves], 0.1), got)
