"""The port's z-blocked red-black solve (``kernels/linsolve_blocked.py``,
ROADMAP B22c) on the CPU, against the JAX package's retired TPU kernel
(``tools/linsolve_blocked.py``) in interpret mode.

The cases are those of tests/test_kernels.py:122-133 (b = 0 and 2 with a
sphere, acc 5) and :176-193 (b = 3, no-slip walls, an empty scene, acc 4,
at the TPU kernel's z-block sizes there; the port has no blocks, so every
block size must give its one answer). The sphere cases are bitwise: the
plain version runs the same operations per cell in the same order, and with
a = 1 no product rounds. The no-slip case has a = 0.8, where XLA on the CPU
contracts ``prev + a*s`` into a fused multiply-add and torch rounds the
product first: atol 3e-7 there, the JAX suite's own bound for that noise
(tests/test_kernels.py:611); the measured gap is 5.96e-8 at |f| <= 2.41.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.kernels.linsolve_blocked import (
    rbgs_solve_blocked, rbgs_solve_blocked_plain)
from fluid_simulation_tpu_torch.kernels.linsolve_sweep import rbgs_sweep_plain
from fluid_simulation_tpu_torch.scene.masks import build_masks
from tools.linsolve_blocked import pallas_rbgs_solve_blocked

torch.set_num_threads(1)

CPU = "cpu"
W, H, D = 16, 8, 8


def _fields(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
            for _ in range(2)]


def _sphere():
    return np.asarray(add_sphere(empty_obstacles(W, H, D), W // 3, H // 2,
                                 D // 2, 2.5), np.float32)


@pytest.mark.parametrize("b", [0, 2])
def test_blocked_solve_matches_jax_sphere(b):
    f, g = _fields(0)
    obs = _sphere()
    jm = jax_build_masks(obs)
    jkeep = jm.keep_vel if b else jm.keep_scalar
    want = pallas_rbgs_solve_blocked(b, jnp.asarray(f), jnp.asarray(g), jkeep,
                                     1.0, 6.0, acc=5, interpret=True)
    m = build_masks(obs, device=CPU)
    keep = m.keep_vel if b else m.keep_scalar
    got = rbgs_solve_blocked(b, torch.tensor(f), torch.tensor(g), keep, 1.0,
                             6.0, acc=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("blk", [2, 3, 5, D + 2])
def test_blocked_solve_matches_jax_noslip_empty(blk):
    f, g = _fields(7)
    want = pallas_rbgs_solve_blocked(3, jnp.asarray(f), jnp.asarray(g), None,
                                     0.8, 5.8, acc=4, wall_mode="noslip",
                                     interpret=True, empty_scene=True,
                                     blk=blk)
    got = rbgs_solve_blocked(3, torch.tensor(f), torch.tensor(g), None, 0.8,
                             5.8, acc=4, wall_mode="noslip", empty_scene=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-7)


def test_padded_sweep_differs_only_at_the_z_ghost_borders():
    """Why B22c is not B20 as it stands: B20's sweep with the field's own
    ghost rows as its black-phase planes zeroes the borders of the z ghost
    rows, which the blocked sweep passes through (times keep); every other
    cell agrees bitwise."""
    f, g = (torch.tensor(x) for x in _fields(0))
    keep = build_masks(_sphere(), device=CPU).keep_vel
    blocked = rbgs_solve_blocked_plain(1, f, g, keep, 1.0, 6.0, acc=3)
    swept = f
    for _ in range(3):
        swept = rbgs_sweep_plain(1, swept, g, keep, swept[0].clone(),
                                 swept[-1].clone(), 1.0, 6.0)
    differ = (blocked != swept).nonzero()
    assert len(differ) > 0
    for z, y, x in differ.tolist():
        assert z in (0, D + 1) and (y in (0, H + 1) or x in (0, W + 1))
    assert torch.equal(swept[1:-1], blocked[1:-1])
    assert torch.equal(swept[:, 1:-1, 1:-1], blocked[:, 1:-1, 1:-1])


def test_blocked_solve_needs_its_keep():
    f = torch.zeros((D + 2, H + 2, W + 2))
    assert torch.equal(rbgs_solve_blocked(1, f, f, None, 1.0, 6.0, acc=2,
                                          empty_scene=True), f)
    with pytest.raises(ValueError, match="keep"):
        rbgs_solve_blocked(1, f, f, None, 1.0, 6.0, acc=2)
