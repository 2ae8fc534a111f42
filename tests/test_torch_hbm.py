"""The streaming-ceiling probes' stream (``kernels/hbm.py``, ROADMAP B23) and
the probes ``fluid_simulation_tpu_torch/tools/exp_hbm.py`` and
``exp_hbm2.py`` on the CPU.

The JAX kernel bodies are closures inside ``main()`` of ``tools/exp_hbm.py``
(:23) and ``tools/exp_hbm2.py`` (:24) and cannot be imported, so this file
restates each as a ``pl.pallas_call(..., interpret=True)`` with the tools'
own bodies and BlockSpec index maps (``exp_hbm2.py:44-49``: the ceil
``nhb`` that also covers a D that is not a multiple of the block), and
holds ``stream_copy_plain`` to it at (W, H, D) = (16, 8, 48), three whole
z-blocks, and (16, 8, 40), whose last block is half full. The copies are
bitwise. In the 14-step chain XLA on the CPU may contract ``acc*1.0001 +
b`` into a fused multiply-add where torch rounds the product first: each
step then differs by at most half an ulp of its product, carried forward
times 1.0001 a step, so the bound is 14 ulps of the largest |acc|
(CHAIN_ULPS).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fluid_simulation_tpu_torch.kernels.hbm import (
    HB, stream_copy, stream_copy_plain, window_planes)
from fluid_simulation_tpu_torch.tools import _timing, exp_hbm, exp_hbm2

torch.set_num_threads(1)

CHAIN_ULPS = 14
SHAPES = [(16, 8, 48), (16, 8, 40)]
TINY = ["--device", "cpu", "--shape", "16", "8", "40", "--n", "2"]


def jax_stream(form, c, r, blk=16, hb=HB):
    """The JAX tools' body ``form`` over (D, H, W) ``c`` (and ``r``), as
    their pallas_calls run it, in interpret mode."""
    D, H, W = c.shape
    nhb = -(-D // hb)
    mid = pl.BlockSpec((blk, H, W), lambda k: (k, 0, 0))
    lo = pl.BlockSpec((hb, H, W), lambda k: (jnp.maximum(k * 2 - 1, 0), 0,
                                             0))
    hi = pl.BlockSpec((hb, H, W), lambda k: (jnp.minimum(k * 2 + 2, nhb - 1),
                                             0, 0))

    def k1(a_ref, o_ref):                              # exp_hbm.py:72-73
        o_ref[...] = a_ref[...] + 1.0

    def k2(a_ref, b_ref, o_ref):                       # exp_hbm.py:82-83
        o_ref[...] = a_ref[...] + b_ref[...]

    def k2h(alo, a, ahi, blo, b, bhi, o_ref):          # exp_hbm.py:109-110
        o_ref[...] = (a[...] + b[...] + alo[0] + ahi[0])

    def ksw(alo, a, ahi, blo, b, bhi, o_ref):          # exp_hbm.py:120-126
        x = a[...]
        y = b[...]
        acc = x
        for _ in range(14):
            acc = acc * 1.0001 + y
        o_ref[...] = acc + alo[0] + ahi[0]

    body, specs, args = {
        "copy1": (k1, [mid], (c,)),
        "copy2": (k2, [mid, mid], (c, r)),
        "copy2h": (k2h, [lo, mid, hi] * 2, (c, c, c, r, r, r)),
        "sweepish": (ksw, [lo, mid, hi] * 2, (c, c, c, r, r, r)),
    }[form]
    return np.asarray(pl.pallas_call(
        body, grid=(-(-D // blk),), in_specs=specs, out_specs=mid,
        out_shape=jax.ShapeDtypeStruct(c.shape, c.dtype),
        interpret=True)(*(jnp.asarray(x) for x in args)))


# (JAX body, blk, keywords of stream_copy_plain, two inputs)
FORMS = {
    "copy1": ("copy1", 16, dict(), False),
    "copy1_blk32": ("copy1", 32, dict(), False),
    "copy2": ("copy2", 16, dict(), True),
    "copy2h": ("copy2h", 16, dict(halo=True), True),
    "sweepish": ("sweepish", 16, dict(halo=True, chain=True), True),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_stream_matches_jax_body(form, shape):
    body, blk, kw, two = FORMS[form]
    W, H, D = shape
    rng = np.random.default_rng(7)
    c, r = (rng.normal(size=(D, H, W)).astype(np.float32) for _ in range(2))
    want = jax_stream(body, c, r, blk)
    got = stream_copy_plain(torch.tensor(c), torch.tensor(r) if two
                            else None, blk=blk, **kw).numpy()
    if "chain" in kw:
        ulp = np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ULPS * ulp)
    else:
        np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version on the CPU
    assert np.array_equal(stream_copy(torch.tensor(c), torch.tensor(r)
                                      if two else None, blk=blk,
                                      **kw).numpy(), got)


@pytest.mark.parametrize("D,blk,lo,hi", [
    (48, 16, [0, 8, 24], [16, 32, 40]),
    (40, 16, [0, 8, 24], [16, 32, 32]),
    (64, 32, [0, 24], [32, 56]),
])
def test_window_planes_follow_the_index_maps(D, blk, lo, hi):
    """Per z-block, the first planes of its windows: hb*max(k*r - 1, 0)
    and hb*min(k*r + r, nhb - 1)."""
    got_lo, got_hi = window_planes(D, blk)
    assert got_lo[::blk].tolist() == lo and got_hi[::blk].tolist() == hi


@pytest.mark.parametrize("kw,match", [
    (dict(blk=0), "blk"),
    (dict(blk=16, halo=True, two=False), "two inputs"),
    (dict(blk=16, chain=True), "chain"),
    (dict(blk=12, halo=True), "divide"),
])
def test_stream_refuses_forms_the_tools_lack(kw, match):
    kw = dict(kw)
    a = torch.zeros((4, 2, 8))
    b = a.clone() if kw.pop("two", True) else None
    for fn in (stream_copy, stream_copy_plain):
        with pytest.raises(ValueError, match=match):
            fn(a, b, **kw)


@pytest.mark.parametrize("D", [48, 40, 9])
def test_window_bytes_count_every_window_plane(D):
    """The windows' bytes, block by block: two hb-plane windows a block,
    the last clipped to D."""
    H, W = 3, 4
    lo, hi = window_planes(D, 16)
    want = sum(min(int(z) + HB, D) - int(z) for k in range(0, D, 16)
               for z in (lo[k], hi[k]))
    assert exp_hbm.window_bytes((D, H, W)) == want * H * W * 4


def _loaded_by_pass(shape, nsw):
    """Loads and stores of rbgs_pass<nsw>, block by block, as the tile
    kernel makes them: every in-domain tile cell once, one rhs load per
    update of a cell of the half-sweep's colour in its region, every
    output cell once."""
    D, H, W = shape
    T, M = (8, 8, 32), 2 * nsw
    loads = updates = 0
    for z0 in range(0, D, T[0]):
        for y0 in range(0, H, T[1]):
            for x0 in range(0, W, T[2]):
                def box(m):
                    return [np.arange(o - m, o + t + m) for o, t in
                            zip((z0, y0, x0), T)]
                z, y, x = np.meshgrid(*box(M), indexing="ij")
                inside = (z >= 0) & (z < D) & (y >= 0) & (y < H) & \
                         (x >= 0) & (x < W)
                loads += int(inside.sum())
                for h in range(2 * nsw):
                    z, y, x = np.meshgrid(*box(M - h - 1), indexing="ij")
                    inside = (z >= 0) & (z < D) & (y >= 0) & (y < H) & \
                             (x >= 0) & (x < W)
                    colour = ((z + y + x) % 2) == (1 - h % 2)
                    updates += int((inside & colour).sum())
    return 4 * (loads + updates + D * H * W)


@pytest.mark.parametrize("shape,nsw", [((16, 8, 32), 1), ((16, 8, 32), 2),
                                       ((10, 7, 13), 2)])
def test_pass_issued_bytes_counts_the_tile_kernel(shape, nsw):
    """The model of prod1's issued bytes against the tile kernel's loads
    counted cell by cell: equal up to the half a cell a row that "half the
    region" rounds."""
    want = _loaded_by_pass(shape, nsw)
    got = exp_hbm2.pass_issued_bytes(shape, nsw)
    D, H, W = shape
    assert abs(got - want) <= 4 * 2 * nsw * D * H   # rows of the regions


@pytest.mark.parametrize("tool,names", [
    (exp_hbm, ["copy1", "copy2", "xla2", "copy1_blk32", "copy2h",
               "sweepish"]),
    (exp_hbm2, ["copy2d", "copy2hd", "arithd", "prod1"]),
])
def test_probe_runs_its_rows_on_the_cpu(tool, names, capsys):
    assert tool.main(list(TINY)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    assert [ln.split()[0] for ln in lines[1:]] == names
    assert all(ln.endswith("(host clock; no rate)") for ln in lines[1:])


def test_probe_rows_compute_their_forms():
    """On the CPU every row runs its plain version: copy1 adds 1, copy2 of
    the same array doubles it, prod1 is one sweep of the carry."""
    rows = {r.name: r for r in exp_hbm.rows("cpu", (16, 8, 40))}
    c = rows["copy1"].x0
    assert torch.equal(rows["copy1"].step(c), c + 1.0)
    assert torch.equal(rows["copy2"].step(c), c + c)
    assert torch.equal(rows["copy1_blk32"].step(c), c + 1.0)
    rows2 = {r.name: r for r in exp_hbm2.rows("cpu", (16, 8, 40))}
    out = rows2["prod1"].step(rows2["prod1"].x0)
    assert out.shape == (40, 8, 16) and bool(torch.isfinite(out).all())
    assert not torch.equal(out, rows2["prod1"].x0)


def test_graph_arm_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="needs the card"):
        _timing.replay_slope(lambda x: x + 1.0, torch.zeros(2), 2, "cpu")


@pytest.mark.parametrize("tool", [exp_hbm, exp_hbm2])
def test_probe_needs_the_card_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--n", "1"])
