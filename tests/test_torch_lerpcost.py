"""The degrade variants of K3's stacked x pass (``kernels/lerpcost.py``,
ROADMAP B24) and the probe ``fluid_simulation_tpu_torch/tools/
exp_lerpcost.py`` on the CPU.

The JAX kernel body is a closure inside ``main`` of
``tools/exp_lerpcost.py`` and cannot be imported, so this file restates it
(``make_kernel``, :29-53), patches it over
``advect_pallas._make_lerp_kernel_stack`` with ``monkeypatch`` as the tool
does at :55, and runs the JAX package's ``lane_lerp_stack`` in interpret
mode; ``full`` is the unpatched production kernel. Each variant's plain
version is held to it within 1e-5, the ``LERP_ATOL`` of
``tests/test_torch_transpose.py``: XLA on the CPU contracts the lerp
``a*(1-s) + b*s`` into a fused multiply-add (the two differ by 1-2 ulp
here). The geometries: the tool's 256^3 x pass cut to 37 rows (C = 258,
Co = 256, windows [0, 127, 130]) and a ragged C = 200, Co = 198 (windows
[0, 72], a partial second chunk of output lanes), with ``xb`` over
[-1, C] so that both clips bite. A NumPy oracle of each variant, written
from the variants' table, holds the plain version bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluid_simulation_tpu.kernels.advect_pallas as ap
from fluid_simulation_tpu_torch.kernels.lerpcost import (
    VARIANTS, lerpcost_pass, lerpcost_pass_plain, window_offsets)
from fluid_simulation_tpu_torch.tools import exp_lerpcost

torch.set_num_threads(1)

LERP_ATOL = 1e-5               # tests/test_torch_transpose.py
GEOMETRIES = [(258, 256), (200, 198)]
ROWS = 37


def _inputs(C, Co, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((3, ROWS, C)).astype(np.float32)
    xb = rng.uniform(-1.0, C, size=(ROWS, Co)).astype(np.float32)
    return arr, xb


def tool_kernel(variant, Bn, C):
    """``make_kernel`` of tools/exp_lerpcost.py:29-53 for ``variant``."""
    offs = ap._window_offsets(C)

    def kernel(arr_ref, xb_ref, out_ref):
        xb = xb_ref[...]
        i0 = jnp.clip(jnp.floor(xb).astype(jnp.int32), 0, C - 2)
        s = xb - i0.astype(xb.dtype)
        for b in range(Bn):
            if variant == "gather1":
                w = arr_ref[b][:, :128]
                li = jnp.clip(i0, 0, 126)
                a = jnp.take_along_axis(w, li, axis=1)
                bb = jnp.take_along_axis(w, li + 1, axis=1)
            elif variant == "nogather":
                acc = jnp.zeros(xb.shape, jnp.float32)
                for off in offs:
                    acc = acc + arr_ref[b][:, off:off + 128]
                a = acc
                bb = acc
            else:  # copy: DMA only
                a = arr_ref[b][:, :128]
                bb = a
            out_ref[b] = a * (1.0 - s) + bb * s
    return kernel


def np_variant(arr, xb, variant):
    """The variant from its definition, in NumPy f32, one rounding per
    operation."""
    Bn, R, C = arr.shape
    Co = xb.shape[1]
    out = np.empty((Bn, R, Co), np.float32)
    one = np.float32(1.0)
    for r in range(R):
        for c in range(Co):
            x = xb[r, c]
            i0 = min(max(int(np.floor(x)), 0), C - 2)
            s = x - np.float32(i0)
            lane = c % 128
            for b in range(Bn):
                row = arr[b, r]
                if variant == "full":
                    a, hi = row[i0], row[i0 + 1]
                elif variant == "gather1":
                    a, hi = row[min(i0, 126)], row[min(i0, 126) + 1]
                elif variant == "nogather":
                    a = np.float32(0.0)
                    for off in window_offsets(C):
                        a = a + row[off + lane]
                    hi = a
                else:
                    a = hi = row[lane]
                out[b, r, c] = a * (one - s) + hi * s
    return out


# every variant at both geometries; full also on the single-window path
# (C <= 128), which the degrade variants refuse
@pytest.mark.parametrize("variant, C, Co", [
    (v, C, Co) for v in VARIANTS for C, Co in GEOMETRIES]
    + [("full", 100, 100)])
def test_plain_matches_the_tool_in_interpret_mode(monkeypatch, variant, C,
                                                  Co):
    arr, xb = _inputs(C, Co)
    if variant != "full":
        monkeypatch.setattr(ap, "_make_lerp_kernel_stack",
                            lambda Bn, C_: tool_kernel(variant, Bn, C_))
    want = np.asarray(ap.lane_lerp_stack(jnp.asarray(arr), jnp.asarray(xb),
                                         interpret=True))
    got = lerpcost_pass_plain(torch.tensor(arr), torch.tensor(xb), variant)
    assert got.shape == want.shape == (3, ROWS, Co)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LERP_ATOL)


@pytest.mark.parametrize("C, Co", GEOMETRIES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_numpy_oracle(variant, C, Co):
    arr, xb = _inputs(C, Co, seed=1)
    arr, xb = arr[:, :5], xb[:5]
    got = lerpcost_pass(torch.tensor(arr), torch.tensor(xb), variant)
    np.testing.assert_array_equal(got.numpy(), np_variant(arr, xb, variant))


def test_window_offsets_match_the_lane_kernel():
    for C in (128, 129, 200, 254, 256, 258, 514, 1664):
        assert window_offsets(C) == ap._window_offsets(C)
    assert window_offsets(258) == [0, 127, 130]


@pytest.mark.parametrize("variant", VARIANTS)
def test_refusals_on_the_host(variant):
    arr, xb = (torch.tensor(a) for a in _inputs(258, 256))
    with pytest.raises(ValueError, match="row mismatch"):
        lerpcost_pass(arr, xb[:-1], variant)
    with pytest.raises(ValueError, match="too wide"):
        lerpcost_pass(torch.zeros(1, 2, 1665), torch.zeros(2, 4), variant)
    with pytest.raises(ValueError, match="idx width"):
        lerpcost_pass(torch.zeros(1, 2, 100), torch.zeros(2, 98), variant)
    with pytest.raises(NotImplementedError, match="A11"):
        lerpcost_pass(arr.to(torch.bfloat16), xb, variant)
    if variant != "full":
        with pytest.raises(ValueError, match="at least 128"):
            lerpcost_pass(torch.zeros(1, 2, 100), torch.zeros(2, 100),
                          variant)
    with pytest.raises(ValueError, match="unknown variant"):
        lerpcost_pass(arr, xb, "gather2")


def test_probe_runs_on_the_cpu(capsys):
    assert exp_lerpcost.main(["--device", "cpu", "--shape", "130", "6", "4",
                              "--n", "2"]) == 0
    out = capsys.readouterr().out
    assert "host CPU" in out and "GB/s" not in out
    for name in VARIANTS + ("k3_xpass",):
        assert name in out
