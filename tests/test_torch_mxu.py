"""The tensor-core probe's solve (``kernels/linsolve_mxu.py``, ROADMAP B23)
and the probe ``fluid_simulation_tpu_torch/tools/exp_solve_mxu.py`` on the
CPU.

``rbgs_solve_mxu_plain`` is held bitwise to the JAX tool's own kernel,
``tools/exp_solve_mxu.py::make_mxu_solve``, run in interpret mode (its
``pallas_call`` patched to ``interpret=True`` for the test), and to the
port's resident solve ``kernels.linsolve.rbgs_solve(0, ...,
packed=False)``, at padded shapes (8, 7, 10), (8, 10, 12) and (10, 9, 130)
(W2 = 130, the tool's 128-wide interior) and acc 3 and 15: the band's two
non-zero terms add exactly, so the x pair equals K1's ``x+ + x-``.
"""

import functools

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, _build, reset_launches)
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
from fluid_simulation_tpu_torch.kernels.linsolve_mxu import (
    band_flops, rbgs_solve_mxu, rbgs_solve_mxu_plain)
from fluid_simulation_tpu_torch.tools import exp_solve_mxu
from tools.exp_solve_mxu import make_mxu_solve

torch.set_num_threads(1)

SHAPES = [(8, 7, 10), (8, 10, 12), (10, 9, 130)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX tool's pallas_call in interpret mode, so it runs here."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("acc", [3, 15])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_jax_kernel(interpret, shape, acc):
    f0, g0 = _inputs(shape)
    want = np.asarray(make_mxu_solve(acc, 1.0, 6.0, shape)(f0, g0))
    got = rbgs_solve_mxu_plain(torch.tensor(f0), torch.tensor(g0), 1.0, 6.0,
                               acc)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on the CPU
    assert torch.equal(rbgs_solve_mxu(torch.tensor(f0), torch.tensor(g0),
                                      1.0, 6.0, acc), got)


@pytest.mark.parametrize("a,c", [(1.0, 6.0), (0.37, 3.22)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_bitwise_to_k1_unpacked(shape, a, c):
    f0, g0 = (torch.tensor(x) for x in _inputs(shape, seed=1))
    got = rbgs_solve_mxu_plain(f0, g0, a, c, 15)
    want = rbgs_solve(0, f0, g0, a, c, 15, packed=False)
    assert torch.equal(got, want)


def test_band_flops_count_three_k_steps_a_tile():
    """At the tool's 128x64x64, acc 15: 8 x 8 tiles of 24 flops a cell
    against the dense product's 2*W2 a padded cell."""
    band, dense = band_flops((66, 66, 130), 15)
    assert band == 2 * 15 * 64 * 8 * 16 * 3 * 512
    assert dense == 2 * 15 * 2 * 66 * 66 * 130 * 128
    assert dense / band > 10


@pytest.mark.parametrize("kw,match", [
    (dict(shape=(8, 7)), "padded shape"),
    (dict(shape=(8, 2, 10)), "padded shape"),
    (dict(shape=(8, 7, 10), prev=(8, 7, 11)), "prev"),
    (dict(shape=(8, 7, 10), acc=-1), "acc"),
])
def test_refused_shapes_raise(kw, match):
    f = torch.zeros(kw["shape"])
    p = torch.zeros(kw.get("prev", kw["shape"]))
    for fn in (rbgs_solve_mxu, rbgs_solve_mxu_plain):
        with pytest.raises(ValueError, match=match):
            fn(f, p, acc=kw.get("acc", 3))


def test_probe_runs_its_rows_on_the_cpu(capsys):
    assert exp_solve_mxu.main(["--device", "cpu", "--shape", "10", "7",
                               "6", "--acc", "3", "--n", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    assert lines[1] == "max |base - mxu_x| = 0.000e+00 (BIT-EQUAL)"
    assert "base" in lines[2] and "mxu_x" in lines[2]


def test_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_solve_mxu.main(["--n", "1"])


def test_card_branch_is_one_count_for_2acc_launches(monkeypatch):
    """On the card the wrapper launches 2*acc half-sweeps in place on a
    clone, counted once; a float64 field raises."""
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda name, device, *args:
                        calls.append((name, args[2:5], args[7])))
    reset_launches()
    f0, g0 = (torch.tensor(x) for x in _inputs((8, 7, 10)))
    out = rbgs_solve_mxu(f0, g0, acc=3)
    assert out.data_ptr() != f0.data_ptr() and torch.equal(out, f0)
    assert calls == [("fst_rbgs_half_mxu", (6, 5, 8), color)
                     for _ in range(3) for color in (0, 1)]
    assert LAUNCHES["rbgs_solve_mxu"] == 1
    with pytest.raises(NotImplementedError, match="A11"):
        rbgs_solve_mxu(f0.double(), g0.double())
    reset_launches()
