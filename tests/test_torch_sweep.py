"""Kernels 15 and 20 (the sharded solve's per-slab sweeps): their plain
torch versions against the JAX Pallas kernels they port, the latter run as
the JAX suite runs them on the CPU (``interpret=True``). The CUDA kernels
are held to these plain versions on the card by ``chip_smoke.py``.

Tolerance: 1e-6 on O(1) values, the bound ``test_torch_kernels.py`` uses for
kernel 1: the interpreter contracts some ``a*b + c`` into fused
multiply-adds, torch rounds each operation on its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.linsolve_sweep import (
    pallas_rbgs_sweep, pallas_rbgs_sweep_packed)
from fluid_simulation_tpu_torch.kernels.linsolve_sweep import (
    rbgs_sweep_packed_plain, rbgs_sweep_plain, sweep_supported)

torch.set_num_threads(1)

W, H, DL = 16, 8, 4          # a 16x8x8 tunnel over two slabs
PAD = (DL + 2, H + 2, W + 2)
A, C = 0.7, 5.2


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _keep(rng, shape):
    """A random 0/1 keep with a ghost shell of ones, as scene masks have."""
    k = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    k[0] = k[-1] = 1.0
    k[:, 0] = k[:, -1] = 1.0
    k[:, :, 0] = k[:, :, -1] = 1.0
    return k


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_packed_sweep_matches_pallas(b, wall_mode):
    rng = np.random.default_rng(10 * b + (wall_mode == "noslip"))
    fk, rp = _rand(rng, (DL, H, W)), _rand(rng, (DL, H, W))
    kp = _keep(rng, PAD)[1:-1, 1:-1, 1:-1]
    gx = [_rand(rng, (DL, H)) for _ in range(2)]
    gy = [_rand(rng, (DL, W)) for _ in range(2)]
    planes = [_rand(rng, (H, W)) for _ in range(4)]
    args = (fk, rp, kp, *gx, *gy, *planes)
    want = pallas_rbgs_sweep_packed(b, *map(jnp.asarray, args), A, C,
                                    wall_mode=wall_mode, interpret=True)
    got = rbgs_sweep_packed_plain(b, *map(_t, args), A, C, wall_mode)
    assert len(got) == len(want) == 7
    for name, g, w in zip(("fk", "gx0", "gx1", "gy0", "gy1", "gz0", "gz1"),
                          got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("apply_keep", [True, False])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_padded_sweep_matches_pallas(b, wall_mode, apply_keep):
    rng = np.random.default_rng(100 + 10 * b + (wall_mode == "noslip"))
    field, prev = _rand(rng, PAD), _rand(rng, PAD)
    keep = _keep(rng, PAD)
    keep[0, 2, 3] = keep[1, 0, 0] = 0.0     # keep reaches the ghosts here
    bp_lo, bp_hi = _rand(rng, PAD[1:]), _rand(rng, PAD[1:])
    args = (field, prev, keep, bp_lo, bp_hi)
    want = pallas_rbgs_sweep(b, *map(jnp.asarray, args), A, C,
                             wall_mode=wall_mode, interpret=True,
                             apply_keep=apply_keep)
    got = rbgs_sweep_plain(b, *map(_t, args), A, C, wall_mode, apply_keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_packed_and_padded_sweeps_agree():
    """The packed sweep is the padded one in another layout: from the same
    slab (keep 1 on the ghost shell) they give the same values bitwise."""
    rng = np.random.default_rng(7)
    field, prev = _t(_rand(rng, PAD)), _t(_rand(rng, PAD))
    keep = _t(_keep(rng, PAD))
    bp_lo, bp_hi = _t(_rand(rng, PAD[1:])), _t(_rand(rng, PAD[1:]))
    padded = rbgs_sweep_plain(1, field, prev, keep, bp_lo, bp_hi, A, C)
    i = (slice(1, -1),) * 2
    fk, gx0, gx1, gy0, gy1, gz0, gz1 = rbgs_sweep_packed_plain(
        1, field[1:-1, 1:-1, 1:-1], prev[1:-1, 1:-1, 1:-1],
        keep[1:-1, 1:-1, 1:-1], field[1:-1, 1:-1, 0], field[1:-1, 1:-1, -1],
        field[1:-1, 0, 1:-1], field[1:-1, -1, 1:-1], field[0][i],
        field[-1][i], bp_lo[i], bp_hi[i], A, C)
    assert torch.equal(fk, padded[1:-1, 1:-1, 1:-1])
    # the padded faces are the pre-keep mirrors times keep 1 on the shell
    assert torch.equal(gx0, padded[1:-1, 1:-1, 0])
    assert torch.equal(gx1, padded[1:-1, 1:-1, -1])
    assert torch.equal(gy0, padded[1:-1, 0, 1:-1])
    assert torch.equal(gy1, padded[1:-1, -1, 1:-1])
    assert torch.equal(gz0, padded[0][i]) and torch.equal(gz1, padded[-1][i])


@pytest.mark.parametrize("shape,dtype,ok", [
    ((6, 10, 18), torch.float32, True), ((4, 10, 18), torch.float32, True),
    ((5, 10, 18), torch.float32, False),          # odd slab depth 3
    ((3, 10, 18), torch.float32, False),          # Dl = 1
    ((6, 10, 18), torch.bfloat16, False), ((6, 10), torch.float32, False)])
def test_sweep_supported(shape, dtype, ok):
    assert sweep_supported(shape, dtype) is ok
