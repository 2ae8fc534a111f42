"""The port's fused pre-advection block (``kernels/prestep.py``, ROADMAP B22a)
on the CPU, against the JAX package's retired TPU kernel and its chain.

The inputs are the cases of tests/test_kernels.py:575-611 (12x8x8 empty and
with a sphere, reference walls; 10x10x6 with a sphere and no-slip walls,
acc 6), made from a NumPy seed and carried in through
``convert.state_from_numpy``. Tolerance against the JAX side: atol 3e-7,
the JAX test's own bound for its kernel against its chain, since XLA on the
CPU contracts some ``a*b + c`` into fused multiply-adds where torch rounds
each operation. Against the port's own ops chain (``ops.linsolve.diffuse``
x3, then ``ops.project.project``) the plain version is equal in value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.ops.linsolve import diffuse as jax_diffuse
from fluid_simulation_tpu.ops.project import project as jax_project
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.convert import state_from_numpy
from fluid_simulation_tpu_torch.kernels.prestep import (
    prestep, prestep_plain, prestep_supported)
from fluid_simulation_tpu_torch.ops.linsolve import diffuse, diffusion_coeffs
from fluid_simulation_tpu_torch.ops.project import project
from fluid_simulation_tpu_torch.scene.masks import build_masks
from tools.prestep_pallas import pallas_prestep

torch.set_num_threads(1)

CPU = "cpu"
ATOL = 3e-7
ACC = 6
DT, DIFF = 0.05, 2e-5
CASES = [((12, 8, 8), "reference", True), ((12, 8, 8), "reference", False),
         ((10, 10, 6), "noslip", False)]


def _case(dims, empty, seed):
    """Obstacles and four padded fields (vx, vy, vz, dens) from a seed."""
    W, H, D = dims
    obs = empty_obstacles(W, H, D) if empty else add_sphere(
        empty_obstacles(W, H, D), W // 2, H // 2, D // 2, 2)
    rng = np.random.default_rng(seed)
    shape = (D + 2, H + 2, W + 2)
    fields = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    return np.asarray(obs, np.float32), fields


def _port_masks(obs, empty):
    """(fluid_i, keep_vel_i) as the prestep takes them, or (None, None)."""
    if empty:
        return None, None
    m = build_masks(obs, device=CPU)
    return m.fluid_i, m.keep_vel[1:-1, 1:-1, 1:-1]


@pytest.mark.parametrize("dims,wall,empty", CASES)
def test_prestep_matches_jax_kernel_and_chain(dims, wall, empty):
    W, H, D = dims
    obs, fields = _case(dims, empty, seed=9)
    a, c = diffusion_coeffs(W, H, D, DT, DIFF)
    jm = jax_build_masks(obs)
    jv = [jnp.asarray(f) for f in fields[:3]]
    jfl = None if empty else jm.fluid_i
    jkv = None if empty else jm.keep_vel[1:-1, 1:-1, 1:-1]
    want_kernel = pallas_prestep(*jv, jfl, jkv, a, c, acc=ACC,
                                 wall_mode=wall, interpret=True)
    kw = dict(acc=ACC, solver="rbgs", wall_mode=wall, use_pallas=False,
              empty_scene=empty)
    w = [jax_diffuse(b, v, v, jm, DT, DIFF, **kw)
         for b, v in zip((1, 2, 3), jv)]
    want_chain = jax_project(*w, jm, **kw)[:3]

    state = state_from_numpy(fields, device=CPU)
    before = [f.clone() for f in state]
    got = prestep(state.vx, state.vy, state.vz, *_port_masks(obs, empty), a,
                  c, acc=ACC, wall_mode=wall)
    for f, g in zip(state, before):
        assert torch.equal(f, g), "prestep changed its inputs"
    for name, g, k, ch in zip("xyz", got, want_kernel, want_chain):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(k), rtol=0, atol=ATOL,
                                   err_msg=f"v{name} vs pallas_prestep")
        np.testing.assert_allclose(g, np.asarray(ch), rtol=0, atol=ATOL,
                                   err_msg=f"v{name} vs the JAX chain")


@pytest.mark.parametrize("dims,wall,empty", CASES)
def test_prestep_plain_is_the_ops_chain(dims, wall, empty):
    """The plain version equals the port's ops chain in value."""
    W, H, D = dims
    obs, fields = _case(dims, empty, seed=10)
    a, c = diffusion_coeffs(W, H, D, DT, DIFF)
    st = state_from_numpy(fields, device=CPU)
    m = build_masks(obs, device=CPU)
    kw = dict(acc=ACC, solver="rbgs", wall_mode=wall, empty_scene=empty)
    w = [diffuse(b, v, v, m, DT, DIFF, **kw)
         for b, v in zip((1, 2, 3), (st.vx, st.vy, st.vz))]
    want = project(*w, m, **kw)[:3]
    got = prestep_plain(st.vx, st.vy, st.vz, *_port_masks(obs, empty), a, c,
                        ACC, wall)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wv.numpy())


def test_prestep_gate():
    assert prestep_supported((6, 6, 6))
    assert prestep_supported((66, 66, 130), masked=True)
    assert not prestep_supported((3, 10, 18))
    assert not prestep_supported((10, 18))
    assert not prestep_supported((6, 6, 6), torch.bfloat16)
    f = torch.zeros((10, 10, 18))
    with pytest.raises(ValueError, match="both"):
        prestep(f, f, f, torch.ones((8, 8, 16)), None, 0.1, 1.6)
