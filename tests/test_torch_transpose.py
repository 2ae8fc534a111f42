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
    # probe3: 4 forms at 3 shapes, then swap01 and store_strided on the
    # bytes-bound view of --shape
    want = {"probe": 8, "probe3": 14, "boundary": 6}[mode]
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

    def stub_copy(x, shape, strides, out, scale):
        assert len(shape) == len(strides) == 3 and out.is_contiguous()
        seen.append(("strided_copy", strides[1:]))
        v = x.as_strided(shape, strides)
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


# ---- the strided copy's plan: merged dims and the kernel each view takes

@pytest.mark.parametrize("shape,strides,want", [
    ((258, 16, 128), (2048, 128, 1), ((528384,), (1,))),      # contiguous
    ((16, 258, 128), (128, 2048, 1), ((16, 258, 128), (128, 2048, 1))),
    ((258, 128), (1024, 1), ((258, 128), (1024, 1))),          # a[:, 3, :]
    ((258, 2, 128), (2048, 128, 1), ((258, 256), (2048, 1))),  # a[:, 1:3]
    ((258, 16, 64), (2048, 128, 2), ((264192,), (2,))),        # a[..., ::2]
    ((258, 16, 64), (4096, 128, 2), ((258, 1024), (4096, 2))),
    ((1, 16, 1, 128), (0, 128, 7, 1), ((2048,), (1,))),        # sizes 1
    ((8, 128), (0, 1), ((8, 128), (0, 1))),                    # expand
    ((4, 3), (0, 0), ((12,), (0,))),                           # broadcast
    ((1, 1), (5, 9), ((1,), (1,))),                            # one element
])
def test_collapse_merges_dims_whose_strides_chain(shape, strides, want):
    assert ktr.collapse(shape, strides) == want


def test_collapse_keeps_merged_dims_within_32_bits(monkeypatch):
    monkeypatch.setattr(ktr, "MAX_DIM", 1000)
    assert ktr.collapse((10, 10, 20), (200, 20, 1)) == ((10, 200), (200, 1))


def _views():
    """(name, view, path) of every collapse case the kernel has."""
    a = torch.zeros(258, 16, 128)
    return [
        ("store_strided", a, "flat4"),
        ("swap01", a.transpose(0, 1), "rows4"),
        ("strided_row", a[:, 3, :], "rows4"),
        ("merged rank 2", a[:, 1:3, :], "rows4"),
        ("expand", torch.zeros(128).expand(8, 128), "rows4"),
        ("ragged x", a[..., :127], "rows"),
        ("misaligned base", torch.zeros(40, 9, 129)[..., 1:], "rows"),
        ("odd x stride", a[:, :, ::2], "rows"),
        ("misaligned run", a.reshape(-1)[1:4097], "rows"),
        ("ragged run", torch.zeros(13, 7, 5), "rows"),
        ("row stride not of 4", torch.zeros(6, 130)[:, :128], "rows"),
        ("swap02", torch.zeros(16, 8, 12).transpose(0, 2), "rows"),
    ]


@pytest.mark.parametrize("name,view,path", _views(),
                         ids=[v[0] for v in _views()])
def test_copy_plan_picks_the_path(name, view, path):
    assert ktr.copy_path(view) == path


def test_copy_plan_shapes_the_launch():
    P = ktr.CopyPlan
    flat = ktr.copy_plan((1, 1, 528384), (528384, 528384, 1), 0)
    assert flat == P("flat4", (256, 1), (516, 1, 1))
    swap = ktr.copy_plan((16, 258, 128), (128, 2048, 1), 0)
    assert swap == P("rows4", (32, 8), (1, 17, 16), 2)
    wide = ktr.copy_plan((258, 258, 256), (256, 66048, 1), 0)
    assert wide == P("rows4", (64, 4), (1, 33, 258), 2)
    ragged = ktr.copy_plan((1, 4128, 127), (528384, 128, 1), 0)
    assert ragged == P("rows", (128, 2), (1, 1032, 1), 2)
    # strided_row at (130, 8, 128): 9 blocks two rows ahead, under the
    # SMs, so one row ahead in 17
    row = ktr.copy_plan((1, 130, 128), (133120, 1024, 1), 0, sms=132)
    assert row == P("rows4", (32, 8), (1, 17, 1), 1)
    assert ktr.copy_plan((1, 1, 528384), (528384, 528384, 1), 4).path == \
        "rows"
    many = ktr.copy_plan((70000, 2, 3), (6, 3, 1), 0)
    assert many.grid[2] == ktr.GRID_YZ and many.block == (4, 64)


def _emulate(plan, shape, strides):
    """The source offset each output element gets when fst_strided_copy
    runs ``plan``: the kernels' loops over blocks and threads, in NumPy.
    Returns the flat output's offsets (-1 where nothing was written) and
    the number of writes."""
    (n0, n1, n2), (s0, s1, s2) = shape, strides
    out = np.full(n0 * n1 * n2, -1, np.int64)
    writes = 0
    if plan.path == "flat4":
        i = np.arange(plan.grid[0] * plan.block[0])
        i = i[i < n2 // 4]
        for e in range(4):
            out[4 * i + e] = (4 * i + e) * s2
        return out, 4 * len(i)
    w = 4 if plan.path == "rows4" else 1
    cols = n2 // w
    (bx, by), (gx, gy, gz) = plan.block, plan.grid
    j = np.arange(gx * bx)
    j = j[j < cols]
    step = by * gy
    for z in range(gz):
        for i0 in range(z, n0, gz):           # blockIdx.z strides over i0
            for start in range(step):         # a thread's first row
                for i1 in range(start, n1, plan.ahead * step):
                    for u in range(plan.ahead):
                        r = i1 + u * step
                        if r >= n1:
                            continue
                        for e in range(w):
                            dst = (i0 * n1 + r) * n2 + j * w + e
                            out[dst] = i0 * s0 + r * s1 + (j * w + e) * s2
                            writes += len(j)
    return out, writes


@pytest.mark.parametrize("shape,strides", [
    ((1, 1, 64), (64, 64, 1)), ((3, 7, 16), (4, 48, 1)),
    ((5, 9, 13), (300, 30, 2)), ((2, 600, 8), (8, 16, 1)),
    ((70, 3, 5), (20, 5, 1)),
])
@pytest.mark.parametrize("grid_yz", [ktr.GRID_YZ, 2])
@pytest.mark.parametrize("sms", [1, 132])
def test_copy_plan_covers_every_element_once(monkeypatch, shape, strides,
                                             grid_yz, sms):
    """Every output element is written once, from its source offset, also
    where the grid's y and z are capped below the rows (the kernels then
    stride over them), one or two rows ahead."""
    monkeypatch.setattr(ktr, "GRID_YZ", grid_yz)
    plan = ktr.copy_plan(shape, strides, 0, sms)
    got, writes = _emulate(plan, shape, strides)
    n0, n1, n2 = shape
    i0, i1, i2 = np.meshgrid(*map(np.arange, shape), indexing="ij")
    want = (i0 * strides[0] + i1 * strides[1] + i2 * strides[2]).ravel()
    np.testing.assert_array_equal(got, want)
    assert writes == n0 * n1 * n2


def _random_view(seed):
    """A seeded strided view of rank 1-3: a permutation, steps, offsets."""
    rng = np.random.default_rng(seed)
    base = torch.tensor(rng.standard_normal((9, 10, 12), np.float32))
    v = base.permute(*rng.permutation(3))
    idx = tuple(slice(int(rng.integers(0, 2)), None, int(rng.integers(1, 3)))
                for _ in range(3))
    v = v[idx]
    if rng.random() < 0.3:
        v = v[:, int(rng.integers(0, v.shape[1]))]
    elif rng.random() < 0.2:
        v = v.reshape(-1) if v.is_contiguous() else v[0, 0]
    return v


@pytest.mark.parametrize("seed", range(24))
def test_collapsed_view_copies_bitwise(seed):
    """The plain copy of the merged view is the plain copy of the view,
    bit for bit, and the card's stubbed launch gets that merged view."""
    v = _random_view(seed)
    merged = ktr.collapsed_view(v)
    assert merged.ndim == 3 and merged.numel() == v.numel()
    assert torch.equal(strided_copy_plain(merged, 2.5).reshape(v.shape),
                       strided_copy_plain(v, 2.5))
    assert ktr.copy_path(v) in ktr.PATHS


def test_card_branch_launches_the_merged_view(card):
    a = torch.tensor(np.random.default_rng(6).standard_normal(
        (130, 8, 128), np.float32))
    for name, view, path in _views()[:5]:
        got = strided_copy(view, 2.0)
        assert torch.equal(got, strided_copy_plain(view, 2.0)), name
    assert torch.equal(strided_copy(a, 2.0), a * 2.0)
    # store_strided reaches the kernel as one run of 133120 elements
    assert card[-1] == ("strided_copy", (130 * 8 * 128, 1))
    assert LAUNCHES["strided_copy"] == 6


@pytest.mark.parametrize("name,view,path", _views(),
                         ids=[v[0] for v in _views()])
def test_launch_takes_the_merged_layout_and_its_plan(monkeypatch, name, view,
                                                     path):
    """The real ``_launch_copy`` (the library call stubbed) gets the view's
    own pointer with its merged shape and strides, and the memoised plan of
    that layout, a second call the same but for its output; no view is
    built for it."""
    got = []
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: got.append(args))
    monkeypatch.setattr(torch.Tensor, "as_strided", None)
    for _ in range(2):
        strided_copy(view, 2.0)
    shape, strides = ktr.merged(view.shape, view.stride())
    plan = ktr.copy_plan(shape, strides, view.data_ptr() % 16)
    assert got[0][:1] + got[0][2:] == got[1][:1] + got[1][2:]
    assert got[0][0] == view.data_ptr() and got[0][2:8] == shape + strides
    assert got[0][8:] == (2.0, ktr.PATHS.index(path), *plan.block,
                          *plan.grid, plan.ahead)
    assert plan.path == path
