"""The sweep-cost variants of the streamed pass (``kernels/sweepcost.py``,
ROADMAP B23) and the probe ``fluid_simulation_tpu_torch/tools/
exp_sweepcost.py`` on the CPU.

``full``'s plain version is ``linsolve_stream.pass_plain``: bitwise, and
within 1e-6 of the JAX package's one-sweep streamed kernel
(``kernels/linsolve_stream.make_packed_sweep_call``, the kernel that
``tools/exp_sweepcost.py`` degrades and ``tools/exp_hbm2.py`` times as
``prod1``) in interpret mode, chained twice for nsw 2: the bound of
``tests/test_torch_stream.py``, where XLA on the CPU contracts ``rhs +
a*s`` into a fused multiply-add. ``arith`` is bitwise to eager ``jnp`` ops
of ``(rhs + a*(6*f)) * crec``, op by op (nothing to contract). The other
variants are held bitwise to a NumPy oracle of the function each states:
a red-black pass with zero ghost faces (``nosel``), or with the x/y
(``noroll``) or z (``nozn``) neighbours replaced by the cell itself.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.kernels.linsolve_stream import (
    make_packed_sweep_call)
from fluid_simulation_tpu_torch.kernels.linsolve_stream import pass_plain
from fluid_simulation_tpu_torch.kernels.sweepcost import (
    VARIANTS, sweep_pass_variant, sweep_pass_variant_plain)
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.tools import exp_sweepcost

torch.set_num_threads(1)

A, C = 1e-4, 1.0006            # tools/exp_sweepcost.py:42
STREAM_ATOL = 1e-6             # tests/test_torch_stream.py
F32 = np.float32


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(F32),
            rng.normal(size=shape).astype(F32))


def np_pass(f, rhs, variant, nsw, b, wall):
    """The variant's pass in NumPy: ``nsw`` red-black sweeps of the carry,
    each on a padded copy whose faces are the signed mirrors of the sweep's
    input (zeros for nosel), red (odd 0-based coordinate sum) first."""
    a, crec = F32(A), F32(1.0) / F32(C)
    sx, sy, sz = (F32(s) for s in face_signs(b, wall))
    D, H, W = f.shape
    z, y, x = np.indices(f.shape)
    red = (z + y + x) % 2 == 1
    for _ in range(nsw):
        P = np.zeros((D + 2, H + 2, W + 2), F32)
        P[1:-1, 1:-1, 1:-1] = f
        if variant != "nosel":
            P[1:-1, 1:-1, 0] = sx * f[:, :, 0]
            P[1:-1, 1:-1, -1] = f[:, :, -1]
            P[1:-1, 0, 1:-1] = sy * f[:, 0, :]
            P[1:-1, -1, 1:-1] = sy * f[:, -1, :]
            P[0, 1:-1, 1:-1] = sz * f[0]
            P[-1, 1:-1, 1:-1] = sz * f[-1]
        for colour in (red, ~red):
            c = P[1:-1, 1:-1, 1:-1]
            nb = [P[1:-1, 1:-1, 2:], P[1:-1, 1:-1, :-2], P[1:-1, 2:, 1:-1],
                  P[1:-1, :-2, 1:-1], P[2:, 1:-1, 1:-1], P[:-2, 1:-1, 1:-1]]
            if variant == "noroll":
                nb[:4] = [c] * 4
            if variant == "nozn":
                nb[4:] = [c] * 2
            s = nb[0] + nb[1]
            for n in nb[2:]:
                s = s + n
            upd = (rhs + a * s) * crec
            P[1:-1, 1:-1, 1:-1] = np.where(colour, upd, c)
        f = P[1:-1, 1:-1, 1:-1].copy()
    return f


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("b,wall", [(1, "reference"), (0, "reference"),
                                    (3, "noslip")])
def test_full_and_noiota_are_the_production_pass(nsw, b, wall):
    f, r = (torch.tensor(x) for x in _inputs((10, 7, 13)))
    want = pass_plain(f, r, None, b, A, C, nsw, wall)
    for v in ("full", "noiota"):
        assert torch.equal(sweep_pass_variant_plain(f, r, v, nsw, b, A, C,
                                                    wall), want)


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("b,wall", [(1, "reference"), (2, "noslip")])
def test_coalesced_is_the_production_pass(nsw, b, wall):
    """``coalesced`` changes only who loads which word: its function is the
    pass's, on the host and (``sweep_pass_variant``'s CPU branch) alike."""
    f, r = (torch.tensor(x) for x in _inputs((10, 7, 13), seed=nsw + b))
    want = pass_plain(f, r, None, b, A, C, nsw, wall)
    for fn in (sweep_pass_variant_plain, sweep_pass_variant):
        assert torch.equal(fn(f, r, "coalesced", nsw, b, A, C, wall), want)


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("interior,blk", [((16, 8, 16), 8), ((12, 8, 16), 8)])
def test_full_matches_jax_packed_sweep(nsw, interior, blk):
    """The JAX one-sweep streamed kernel, b = 1, empty scene, as
    ``exp_hbm2.py:111-112`` builds it, in interpret mode."""
    f, r = _inputs(interior, seed=3)
    call = make_packed_sweep_call(1, A, C, "reference", interior,
                                  jnp.float32, False, blk, True)
    want = jnp.asarray(f)
    rp = jnp.asarray(r)
    for _ in range(nsw):
        want = call(want, want, want, rp, rp, rp)
    got = sweep_pass_variant_plain(torch.tensor(f), torch.tensor(r), "full",
                                   nsw, 1, A, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STREAM_ATOL)


@pytest.mark.parametrize("nsw", [1, 2])
def test_arith_matches_jnp(nsw):
    f, r = _inputs((9, 6, 11), seed=5)
    a = jnp.float32(A)
    crec = jnp.float32(1.0) / jnp.float32(C)
    want, rhs = jnp.asarray(f), jnp.asarray(r)
    for _ in range(2 * nsw):
        want = (rhs + a * (jnp.float32(6.0) * want)) * crec
    got = sweep_pass_variant_plain(torch.tensor(f), torch.tensor(r), "arith",
                                   nsw, 1, A, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("variant", ["nosel", "noroll", "nozn"])
@pytest.mark.parametrize("b,wall", [(1, "reference"), (2, "noslip")])
def test_variant_matches_numpy_oracle(variant, nsw, b, wall):
    f, r = _inputs((10, 7, 13), seed=11)
    got = sweep_pass_variant_plain(torch.tensor(f), torch.tensor(r), variant,
                                   nsw, b, A, C, wall)
    np.testing.assert_array_equal(got.numpy(),
                                  np_pass(f, r, variant, nsw, b, wall))
    # wrong by design: it is not the pass
    assert not torch.equal(got, pass_plain(torch.tensor(f), torch.tensor(r),
                                           None, b, A, C, nsw, wall))


def test_numpy_oracle_is_the_pass():
    """The oracle with nothing removed is the production pass."""
    f, r = _inputs((10, 7, 13), seed=2)
    np.testing.assert_array_equal(
        np_pass(f, r, "full", 2, 1, "reference"),
        pass_plain(torch.tensor(f), torch.tensor(r), None, 1, A, C, 2)
        .numpy())


@pytest.mark.parametrize("variant,nsw,match", [
    ("fast", 1, "unknown variant"), ("full", 0, "nsw"), ("arith", 3, "nsw")])
def test_refusals(variant, nsw, match):
    f = torch.zeros((4, 4, 4))
    for fn in (sweep_pass_variant, sweep_pass_variant_plain):
        with pytest.raises(ValueError, match=match):
            fn(f, f, variant, nsw, 1, A, C)


def test_probe_runs_its_rows_on_the_cpu(capsys):
    assert exp_sweepcost.main(["--device", "cpu", "--shape", "16", "8", "16",
                               "--n", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    rows = 2 * (len(VARIANTS) + 1)
    names = [" ".join(ln.split()[:2]) for ln in lines[1:rows + 1]]
    assert names == [f"{v} nsw={n}" for n in (1, 2)
                     for v in VARIANTS + ("rbgs_pass",)]
    assert lines[rows + 1].startswith("copy2hd")
    assert "no rate" in lines[rows + 1]
    assert lines[rows + 2].startswith("full nsw=1 / copy2hd")


def test_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_sweepcost.main(["--n", "1"])
