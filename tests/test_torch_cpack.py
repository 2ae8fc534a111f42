"""The port's colour-packed red-black solve (``kernels/linsolve_cpack.py``,
ROADMAP B22b) on the CPU, against the JAX package's retired TPU kernels
(``tools/linsolve_cpack.py``) in interpret mode and against the port's K1.

The resident cases are the shapes of tests/test_kernels.py:513-540, at the
JAX test's a = 0.3, c = 2.8 and at a = 1, c = 6. At a = 0.3 XLA on the CPU
contracts ``prev + a*s`` into a fused multiply-add where torch rounds the
product first, with a keep and without: atol 2e-7 there, the JAX test's own
bound for that noise (the measured gap is 1.19e-7 at |f| <= 3.62). At
a = 1 no product rounds: with a keep the plain version is bitwise to
``pallas_rbgs_solve_cpack``; on an empty scene the JAX cpack kernel is
itself up to 1.19e-7 off the JAX packed K1 (the JAX test's 2e-7), and the
port is bitwise to that K1 instead. The streamed cases run
``pallas_rbgs_solve_cpack_stream`` with ``blk=8`` at padded (18, 6, 10),
two z-blocks, and (10, 6, 10), one, at a = 1: bitwise. Against the port's K1 plain version
(``rbgs_solve_plain``) both plain versions are bitwise for every case,
no-slip walls included: the same operations per cell in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.linsolve_pallas import pallas_rbgs_solve
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve_plain
from fluid_simulation_tpu_torch.kernels.linsolve_cpack import (
    cpack_supported, pack_colors, rbgs_solve_cpack, rbgs_solve_cpack_plain,
    rbgs_solve_cpack_stream, rbgs_solve_cpack_stream_plain, unpack_colors)
from tools.linsolve_cpack import (
    pack_colors as jax_pack_colors, pallas_rbgs_solve_cpack,
    pallas_rbgs_solve_cpack_stream, unpack_colors as jax_unpack_colors)

torch.set_num_threads(1)

FMA_ATOL = 2e-7
# tests/test_kernels.py:517-520: (padded shape, b, empty scene, acc)
RESIDENT = [((8, 6, 10), 1, True, 5), ((8, 6, 10), 0, False, 5),
            ((6, 8, 12), 2, False, 15), ((10, 4, 8), 3, True, 15)]
STREAMED = [(shape, b, empty, acc)
            for shape, acc in (((18, 6, 10), 4), ((10, 6, 10), 3))
            for b in (0, 1, 2) for empty in (False, True)]


def _case(shape, empty, seed):
    """field, prev and a padded keep (None for an empty scene): 20 % random
    solids inside, 1 on the ghost shell."""
    rng = np.random.default_rng(seed)
    field = rng.normal(size=shape).astype(np.float32)
    prev = rng.normal(size=shape).astype(np.float32)
    if empty:
        return field, prev, None
    keep = np.ones(shape, np.float32)
    sol = rng.random(size=tuple(n - 2 for n in shape)) < 0.2
    keep[1:-1, 1:-1, 1:-1] = (~sol).astype(np.float32)
    return field, prev, keep


def _torch(*arrays):
    return [None if x is None else torch.tensor(x) for x in arrays]


@pytest.mark.parametrize("shape", [(6, 5, 8), (5, 3, 6)])
def test_pack_colors_match_jax(shape):
    """The JAX test's (6, 5, 8) seed-7 field, and an odd-D, odd-H one."""
    f = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    R, B = pack_colors(torch.tensor(f))
    jR, jB = jax_pack_colors(jnp.asarray(f))
    np.testing.assert_array_equal(R.numpy(), np.asarray(jR))
    np.testing.assert_array_equal(B.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(unpack_colors(R, B).numpy(), f)
    np.testing.assert_array_equal(
        np.asarray(jax_unpack_colors(jR, jB)), unpack_colors(R, B).numpy())


@pytest.mark.parametrize("a,c", [(0.3, 2.8), (1.0, 6.0)])
@pytest.mark.parametrize("shape,b,empty,acc", RESIDENT)
def test_resident_plain_matches_jax(shape, b, empty, acc, a, c):
    atol = 0.0 if a == 1.0 and not empty else FMA_ATOL
    field, prev, keep = _case(shape, empty, 11)
    want = pallas_rbgs_solve_cpack(
        b, jnp.asarray(field), jnp.asarray(prev),
        None if empty else jnp.asarray(keep), a, c, acc=acc,
        interpret=True, empty_scene=empty)
    got = rbgs_solve_cpack_plain(b, *_torch(field, prev, keep), a, c, acc,
                                 empty_scene=empty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("shape,b,empty,acc", STREAMED)
def test_streamed_plain_matches_jax(shape, b, empty, acc):
    field, prev, keep = _case(shape, empty, 12)
    want = pallas_rbgs_solve_cpack_stream(
        b, jnp.asarray(field), jnp.asarray(prev),
        None if empty else jnp.asarray(keep), 1.0, 6.0, acc=acc,
        interpret=True, empty_scene=empty, blk=8)
    got = rbgs_solve_cpack_stream_plain(b, *_torch(field, prev, keep), 1.0,
                                        6.0, acc, empty_scene=empty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wall", ["reference", "noslip"])
@pytest.mark.parametrize("shape,b,empty,acc", RESIDENT + STREAMED[:4])
def test_plains_match_k1_plain(shape, b, empty, acc, wall):
    field, prev, keep = _case(shape, empty, 13)
    field, prev, keep = _torch(field, prev, keep)
    want = rbgs_solve_plain(b, field, prev, 0.3, 2.8, acc, wall, keep)
    for solve in (rbgs_solve_cpack_plain, rbgs_solve_cpack_stream_plain):
        got = solve(b, field, prev, keep, 0.3, 2.8, acc, wall, empty)
        assert torch.equal(got, want), solve.__name__


@pytest.mark.parametrize("shape,b,empty,acc", RESIDENT)
def test_resident_matches_k1_pallas_interpret(shape, b, empty, acc):
    """The JAX package's packed K1 in interpret mode at a = 1: bitwise,
    through the CPU wrapper, empty scenes included."""
    field, prev, keep = _case(shape, empty, 11)
    want = pallas_rbgs_solve(b, jnp.asarray(field), jnp.asarray(prev),
                             None if empty else jnp.asarray(keep), 1.0, 6.0,
                             acc=acc, interpret=True, empty_scene=empty,
                             packed=True)
    got = rbgs_solve_cpack(b, *_torch(field, prev, keep), 1.0, 6.0, acc,
                           empty_scene=empty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("solve", [rbgs_solve_cpack, rbgs_solve_cpack_stream])
def test_acc_0_and_1(solve):
    field, prev, keep = _torch(*_case((8, 6, 10), False, 15))
    out = solve(1, field, prev, keep, 0.3, 2.8, acc=0)
    assert torch.equal(out, field) and out.data_ptr() != field.data_ptr()
    one = rbgs_solve_plain(1, field, prev, 0.3, 2.8, 1, keep=keep)
    assert torch.equal(solve(1, field, prev, keep, 0.3, 2.8, acc=1), one)


@pytest.mark.parametrize("solve", [rbgs_solve_cpack, rbgs_solve_cpack_stream])
def test_refusals(solve):
    odd = torch.zeros((8, 6, 9))
    assert not cpack_supported(odd.shape)
    with pytest.raises(ValueError, match="even interior W"):
        solve(1, odd, odd, None, 0.3, 2.8, empty_scene=True)
    thin = torch.zeros((3, 6, 10))
    with pytest.raises(ValueError, match="even interior W"):
        solve(1, thin, thin, None, 0.3, 2.8, empty_scene=True)
    bf = torch.zeros((8, 6, 10), dtype=torch.bfloat16)
    assert not cpack_supported(bf.shape, bf.dtype)
    with pytest.raises(NotImplementedError, match="A11"):
        solve(1, bf, bf, None, 0.3, 2.8, empty_scene=True)
    f = torch.zeros((8, 6, 10))
    with pytest.raises(ValueError, match="keep"):
        solve(1, f, f, None, 0.3, 2.8)
