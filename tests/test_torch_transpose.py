"""The transpose probe's kernels (``kernels/transpose.py``, ROADMAP B23),
K3's single pass (``kernels/advect_split.lerp_pass``) and the probe
``fluid_simulation_tpu_torch/tools/exp_transpose.py`` on the CPU.

The JAX kernel bodies are closures inside ``probe`` and ``probe3`` of
``tools/exp_transpose.py`` and cannot be imported, so this file restates
each as a ``pl.pallas_call(..., interpret=True)`` with the tool's own body
and holds the plain versions to it bitwise: the 2-D transpose at the
probe's 8 shapes (:71-72), the four rank-3 forms at probe3's 3 shapes
(:192). ``boundary`` (:203-271) reaches K3's ``lane_lerp_stack``; its
x pass, its y pass from a given stack and its y pass on a pre-transposed
stack are restated with ``lane_lerp_stack(..., interpret=True)`` at
(W, H, D) = (130, 6, 4) (the x pass's 132-wide rows take the lane kernel's
multi-window path, as at 256^3) and held to the port's passes within 1e-5,
the bound of K3's own test (``tests/test_torch_kernels.py``): XLA on the
CPU may contract the backtrace or the lerp into a fused multiply-add. The
port's y pass by transposes equals its direct y pass bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fluid_simulation_tpu.kernels.advect_pallas import lane_lerp_stack
from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, _build, advect_split as k3, reset_launches, transpose as ktr)
from fluid_simulation_tpu_torch.kernels.advect_split import (
    lerp_pass, lerp_pass_plain)
from fluid_simulation_tpu_torch.kernels.transpose import (
    strided_copy, strided_copy_plain, transpose2d, transpose2d_plain)
from fluid_simulation_tpu_torch.tools import exp_transpose

torch.set_num_threads(1)

LERP_ATOL = 1e-5
BOUNDARY = (130, 6, 4)
VMEM = dict(in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))


def _call(kernel, out_shape, a):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True, **VMEM)(jnp.asarray(a)))


def jax_probe(a):
    """probe's mk(shape).f (exp_transpose.py:52-64)."""
    def kernel(a_ref, o_ref):
        o_ref[...] = jnp.swapaxes(a_ref[...], 0, 1)
    return _call(kernel, a.shape[::-1], a)


def jax_probe3(name, a):
    """probe3's four bodies (exp_transpose.py:124-189)."""
    Z, Y, X = a.shape
    R = exp_transpose.ROW

    def swap01(a_ref, o_ref):
        o_ref[...] = jnp.swapaxes(a_ref[...], 0, 1)

    def strided_row(a_ref, o_ref):
        o_ref[...] = a_ref[:, R, :]

    def major_slice_T(a_ref, o_ref):
        o_ref[...] = jnp.swapaxes(a_ref[:, R, :], 0, 1)

    def store_strided(a_ref, o_ref):
        for s in range(Y):
            o_ref[:, s, :] = a_ref[:, s, :] * 2.0

    kernel, shape = {"swap01": (swap01, (Y, Z, X)),
                     "strided_row": (strided_row, (Z, X)),
                     "major_slice_T": (major_slice_T, (X, Z)),
                     "store_strided": (store_strided, (Z, Y, X))}[name]
    return _call(kernel, shape, a)


@pytest.mark.parametrize("shape", exp_transpose.PROBE_SHAPES)
def test_transpose_matches_the_jax_probe(shape):
    a = np.random.default_rng(0).standard_normal(shape, np.float32)
    want = jax_probe(a)
    np.testing.assert_array_equal(transpose2d_plain(torch.tensor(a)).numpy(),
                                  want)
    assert torch.equal(transpose2d(torch.tensor(a)), torch.tensor(want))


@pytest.mark.parametrize("shape", exp_transpose.PROBE3_SHAPES)
@pytest.mark.parametrize("name", ["swap01", "strided_row", "major_slice_T",
                                  "store_strided"])
def test_probe3_forms_match_the_jax_bodies(name, shape):
    a = np.random.default_rng(1).standard_normal(shape, np.float32)
    want = jax_probe3(name, a)
    for kernel in (False, True):
        f = {n: f for n, f, _ in exp_transpose.probe3_forms(kernel)}[name]
        got = f(torch.tensor(a))
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_boundary(stack, vx, dtW):
    """The tool's x pass, y pass and y pass on a pre-transposed stack
    (exp_transpose.py:220-251), with lane_lerp_stack in interpret mode.
    Returns (A, B, ypass_alone) before the tool pads x back, and the
    pre-transposed inputs."""
    _, D2, H2, W2 = stack.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    stack, vx = jnp.asarray(stack), jnp.asarray(vx)
    xi = jnp.arange(1, W + 1, dtype=jnp.float32).reshape(1, 1, W)
    xb = jnp.clip(xi - dtW * vx[:, :, 1:-1], 0.5, W + 0.5)
    A = lane_lerp_stack(stack.reshape(3, D2 * H2, W2),
                        xb.reshape(D2 * H2, W), interpret=True)
    A = A.reshape(3, D2, H2, W)
    yi = jnp.arange(1, H + 1, dtype=jnp.float32).reshape(1, H, 1)
    yb = jnp.clip(yi - dtW * vx[:, 1:-1, 1:-1], 0.5, H + 0.5)
    At = jnp.swapaxes(A, 2, 3)                         # (3, D2, W, H2)
    ybt = jnp.swapaxes(yb, 1, 2)
    ybt_full = jnp.concatenate([ybt[:, :, :1], ybt, ybt[:, :, -1:]], axis=2)
    b = lane_lerp_stack(At.reshape(3, D2 * W, H2),
                        ybt_full.reshape(D2 * W, H2), interpret=True)
    alone = b.reshape(3, D2, W, H2)
    B = jnp.swapaxes(alone, 2, 3)                      # (3, D2, H2, W)
    return np.asarray(A), np.asarray(B), np.asarray(alone)


def test_boundary_passes_match_the_jax_tool():
    stack, vx, dtW = exp_transpose.boundary_case(BOUNDARY, "cpu")
    A_j, B_j, alone_j = _jax_boundary(stack.numpy(), vx.numpy(), dtW)
    xpass, ypass_T, ypass_alone, ypass_direct = exp_transpose.passes(False)
    A = xpass(stack, vx, dtW)
    np.testing.assert_allclose(A.numpy(), A_j, rtol=0, atol=LERP_ATOL)
    # the tool's y outputs are H2 wide (edge coordinates repeated); the
    # port's are the H interior rows
    B = ypass_T(A, vx, dtW)
    np.testing.assert_allclose(B.numpy(), B_j[:, :, 1:-1, :], rtol=0,
                               atol=LERP_ATOL)
    alone = ypass_alone(transpose2d_plain(A.reshape(-1, *A.shape[2:]))
                        .reshape(3, A.shape[1], A.shape[3], A.shape[2]),
                        transpose2d_plain(vx), dtW)
    np.testing.assert_allclose(alone.numpy(), alone_j[..., 1:-1], rtol=0,
                               atol=LERP_ATOL)
    assert torch.equal(B, ypass_direct(A, vx, dtW))


@pytest.mark.parametrize("shape", [(13, 7, 5), (4, 9, 3)])
def test_y_pass_by_transposes_is_the_direct_y_pass(shape):
    stack, vx, dtW = exp_transpose.boundary_case(shape, "cpu", seed=2)
    for kernel in (False, True):
        xpass, ypass_T, _, ypass_direct = exp_transpose.passes(kernel)
        A = xpass(stack, vx, dtW)
        assert torch.equal(ypass_T(A, vx, dtW), ypass_direct(A, vx, dtW))


@pytest.mark.parametrize("fn,args,match", [
    (transpose2d, (torch.zeros(5),), "shape"),
    (transpose2d, (torch.zeros(2, 3, 4, 5),), "shape"),
    (strided_copy, (torch.zeros(2, 3, 4, 5),), "rank 1 to 3"),
    (strided_copy, (torch.zeros(0, 3),), "rank 1 to 3"),
    (lerp_pass, (torch.zeros(1, 4, 4, 4), torch.zeros(4, 4, 4), 3, 0.1),
     "axis"),
    (lerp_pass, (torch.zeros(1, 4, 4, 4), torch.zeros(4, 4, 2), 2, 0.1,
                 (0, 0, 1)), "does not cover"),
])
def test_refused_shapes_raise(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args)


@pytest.mark.parametrize("mode", ["probe", "probe3", "boundary"])
def test_probe_runs_its_modes_on_the_cpu(mode, capsys):
    assert exp_transpose.main([mode, "--device", "cpu", "--n", "1",
                               "--shape", "13", "7", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    want = {"probe": 8, "probe3": 12, "boundary": 6}[mode]
    assert len(lines) == 1 + want
    if mode == "boundary":
        assert lines[-1].endswith("max |ypass_T - ypass_direct| = 0 "
                                  "(bound 0)")
    else:
        assert all("exact=True" in ln for ln in lines[1:])


def test_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_transpose.main(["probe", "--n", "1"])


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; the launchers are stubs that
    check what the kernels would be given and write the plain results."""
    seen = []

    def stub_transpose(v, out):
        B, R, C = v.shape
        assert out.is_contiguous() and out.shape == (B, C, R)
        seen.append(("transpose", v.stride()[1:]))
        out.copy_(transpose2d_plain(v))

    def stub_copy(v, out, scale):
        assert v.ndim == 3 and out.is_contiguous()
        seen.append(("strided_copy", v.stride()[1:]))
        out.copy_(strided_copy_plain(v, scale).reshape(out.shape))

    def stub_pass(src, vel, out, axis, dtN, off):
        assert src.is_contiguous() and vel.is_contiguous()
        seen.append(("lerp_pass", axis))
        out.copy_(lerp_pass_plain(src, vel, axis, dtN, off))

    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(ktr, "_launch_transpose", stub_transpose)
    monkeypatch.setattr(ktr, "_launch_copy", stub_copy)
    monkeypatch.setattr(k3, "_launch_pass", stub_pass)
    reset_launches()
    yield seen
    reset_launches()


def test_card_branch_counts_one_launch_a_call(card):
    a = torch.tensor(np.random.default_rng(5).standard_normal(
        (130, 8, 128), np.float32))
    for name, f, lib in exp_transpose.probe3_forms(kernel=True):
        assert torch.equal(f(a), lib(a)), name
    assert LAUNCHES["transpose"] == 1 and LAUNCHES["strided_copy"] == 3
    # strides reach the kernel as the views have them: swap01, a[:, 3, :]
    assert card[0] == ("strided_copy", (8 * 128, 1))
    assert card[1] == ("strided_copy", (8 * 128, 1))
    assert card[2] == ("transpose", (8 * 128, 1))
    stack, vx, dtW = exp_transpose.boundary_case((13, 7, 5), "cpu")
    reset_launches()
    xpass, ypass_T, ypass_alone, ypass_direct = exp_transpose.passes(True)
    A = xpass(stack, vx, dtW)
    assert torch.equal(ypass_T(A, vx, dtW), ypass_direct(A, vx, dtW))
    assert LAUNCHES["lerp_pass"] == 3 and LAUNCHES["transpose"] == 3
    with pytest.raises(NotImplementedError, match="A11"):
        transpose2d(a.double()[:, 0])
    with pytest.raises(NotImplementedError, match="A11"):
        lerp_pass(stack.double(), vx.double(), 2, dtW, (0, 0, 1))
