"""The step's statistics (``kernels/stats.py``) on the CPU.

The plain version keeps the ops the step has always used; the kernel's
divergence is the projections' own (``div_packed``'s arithmetic, whose
plain twin is ``kernels/project.divergence_plain``), empty and masked, and
must give the same |div| as the plain statistic; a statistic that is off
is NaN; a non-finite velocity or density reaches its statistic; and the
step's statistics are the JAX step's, computed on the same fields. The
kernel itself runs only on the card (``chip_smoke.py --only stats``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.ops.project import divergence as jax_divergence
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.convert import state_from_numpy
from fluid_simulation_tpu_torch.kernels import project as k2
from fluid_simulation_tpu_torch.kernels.stats import (
    step_stats, step_stats_plain)
from fluid_simulation_tpu_torch.ops.project import divergence, grid_h
from fluid_simulation_tpu_torch.scene.masks import build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    add_box, add_sphere, empty_obstacles)

torch.set_num_threads(1)

CPU = "cpu"
GRIDS = [(16, 8, 8), (24, 12, 10)]
SCENES = ["empty", "sphere", "box"]


def _obstacles(scene, W, H, D):
    obs = empty_obstacles(W, H, D)
    if scene == "sphere":
        return add_sphere(obs, W // 3, H // 2, D // 2, 3)
    if scene == "box":
        return add_box(obs, W // 4, W // 2, 2, H - 2, 2, D - 2)
    return obs


def _fields(W, H, D, seed=0, obs=None):
    """Random padded fields as a run has them: vx around 20, density
    positive, every field zero in solids."""
    rng = np.random.default_rng(seed)
    pad = (D + 2, H + 2, W + 2)
    vel = [rng.uniform(-3, 3, size=pad) for _ in range(3)]
    vel[0] += 20
    fields = vel + [rng.uniform(0, 0.01, size=pad)]
    if obs is not None:
        fields = [f * (np.asarray(obs) < 0.5) for f in fields]
    return [torch.tensor(f, dtype=torch.float32) for f in fields]


def _case(scene, grid, seed=0):
    W, H, D = grid
    obs = _obstacles(scene, W, H, D)
    return _fields(W, H, D, seed, obs), build_masks(obs, device=CPU)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scene", SCENES)
def test_plain_is_the_steps_old_ops(scene, grid):
    """Bitwise the ops the step ran before the kernel: the obstacle-aware
    divergence as a padded field, |.|.max(), and ``torch.sum`` in float32."""
    (vx, vy, vz, dens), m = _case(scene, grid)
    h = grid_h(*grid)
    density_sum, max_div = step_stats_plain(vx, vy, vz, dens, m)
    assert torch.equal(max_div, divergence(vx, vy, vz, m, h).abs().max()
                       .to(torch.float32))
    assert torch.equal(density_sum, torch.sum(dens, dtype=torch.float32))
    assert max_div.dtype == density_sum.dtype == torch.float32
    assert max_div.shape == density_sum.shape == ()
    # the wrapper takes the plain version for a CPU tensor
    for a, b in zip(step_stats(vx, vy, vz, dens, m, scene == "empty"),
                    (density_sum, max_div)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scene", SCENES)
def test_kernel_divergence_forms_give_the_plain_max(scene, grid):
    """The kernel's arithmetic (``div_packed``'s, as
    ``kernels/project.divergence_plain`` restates it) gives the plain
    statistic's max |div| bitwise: the masked form in every scene, the
    in-bounds form (no ``fluid_i``) in an empty one."""
    (vx, vy, vz, dens), m = _case(scene, grid, seed=1)
    _, want = step_stats_plain(vx, vy, vz, dens, m)
    masked = k2.divergence_plain(vx, vy, vz, m.fluid_i).abs().max()
    assert torch.equal(masked, want)
    if scene == "empty":
        assert torch.equal(k2.divergence_plain(vx, vy, vz).abs().max(), want)


@pytest.mark.parametrize("fn", [step_stats_plain, step_stats])
@pytest.mark.parametrize("divergence_on,density_on", [
    (True, False), (False, True), (False, False)])
def test_statistic_off_is_nan(fn, divergence_on, density_on):
    (vx, vy, vz, dens), m = _case("sphere", GRIDS[0])
    full = step_stats_plain(vx, vy, vz, dens, m)
    got = fn(vx, vy, vz, dens, m, divergence_on=divergence_on,
             density_on=density_on)
    for on, a, b in zip((density_on, divergence_on), got, full):
        assert a.dtype == torch.float32 and a.shape == ()
        if on:
            assert torch.equal(a, b)
        else:
            assert torch.isnan(a)


@pytest.mark.parametrize("scene", ["empty", "sphere"])
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_non_finite_cell_reaches_its_statistic(scene, value, field):
    """One non-finite fluid cell in a velocity makes max_divergence
    non-finite (as torch.max propagates NaN), in the density the density
    sum; the other statistic stays finite."""
    fields, m = _case(scene, GRIDS[0])
    fields[field][3, 4, 2] = value   # a fluid cell, clear of the sphere
    got = step_stats_plain(*fields, m)
    bad = 0 if field == 3 else 1
    assert not bool(torch.isfinite(got[bad]))
    assert bool(torch.isfinite(got[1 - bad]))


@pytest.mark.parametrize("mode", ["split", "compat"])
@pytest.mark.parametrize("scene", ["empty", "sphere"])
def test_step_stats_are_the_jax_steps_on_the_same_fields(mode, scene):
    """A step's statistics against the JAX step's (``jnp.max(jnp.abs(
    divergence(...)))`` and ``jnp.sum`` in float32, eager) computed on the
    fields the step returned: max_divergence bitwise, the density sum to
    the rounding of another summation order (4,368 float32 terms: about
    sqrt(n) * 6e-8 = 4e-6 expected, 1.7e-6 seen)."""
    W, H, D = 24, 12, 10
    obs = (add_sphere(empty_obstacles(W, H, D), 8, 6, 5, 3)
           if scene == "sphere" else empty_obstacles(W, H, D))
    p = SimParams(width=W, height=H, depth=D, mode=mode, acc=8)
    wt = WindTunnel(p, obstacles=obs, device=CPU)
    wt.state = state_from_numpy([f.numpy() for f in _fields(W, H, D, 2)],
                                device=CPU)
    got = wt.step()
    vx, vy, vz, dens = (jnp.asarray(f.numpy()) for f in wt.state)
    jm = jax_build_masks(obs)
    want_div = jnp.max(jnp.abs(jax_divergence(vx, vy, vz, jm,
                                              grid_h(W, H, D))))
    want_sum = jnp.sum(dens, dtype=jnp.float32)
    assert float(got.max_divergence) == float(want_div)
    np.testing.assert_allclose(float(got.density_sum), float(want_sum),
                               rtol=1e-5)


def test_grid_constant_matches_the_source():
    """The wrapper sizes the first launch's grid, and so its partials, with
    the blocks an SM that the kernel's register cap is set for."""
    from fluid_simulation_tpu_torch.kernels import _build, stats
    src = (_build.CSRC / "stats.cu").read_text()
    assert (f"constexpr int kBlocksPerSm = {stats.BLOCKS_PER_SM};"
            in src)
