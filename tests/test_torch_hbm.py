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

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fluid_simulation_tpu_torch.kernels import hbm
from fluid_simulation_tpu_torch.kernels.hbm import (
    HB, ITEM, TILE, item_plan, stream_copy, stream_copy_plain, stream_items,
    window_planes)
from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    MARCH_CHUNK, MARCH_TILE)
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
    """Loads and stores of rbgs_pass<nsw>, block by block and plane by
    plane, as the z-march makes them: at every plane it loads (M = 2*nsw
    under its first output plane to M over its last, in the domain) the
    carry and the rhs at each in-domain cell of its ring plane (its tile
    with a halo of M in x and y); every output cell stored once."""
    D, H, W = shape
    (tx, ty), chunk, m = MARCH_TILE[nsw], MARCH_CHUNK, 2 * nsw
    loads = 0
    for zs in range(0, D, chunk):
        ze = min(zs + chunk, D)
        for y0 in range(-m, H - m, ty):
            for x0 in range(-m, W - m, tx):
                y, x = np.meshgrid(np.arange(y0, y0 + ty + 2 * m),
                                   np.arange(x0, x0 + tx + 2 * m),
                                   indexing="ij")
                plane = int(((y >= 0) & (y < H) & (x >= 0) & (x < W)).sum())
                for q in range(zs - m, ze + m):
                    if 0 <= q < D:
                        loads += 2 * plane
    return 4 * (loads + D * H * W)


@pytest.mark.parametrize("shape,nsw", [((16, 8, 32), 1), ((16, 8, 32), 2),
                                       ((10, 7, 13), 2)])
def test_pass_issued_bytes_counts_the_tile_kernel(shape, nsw):
    """The model of prod1's issued bytes against the z-march's loads and
    stores counted cell by cell: equal."""
    assert exp_hbm2.pass_issued_bytes(shape, nsw) == _loaded_by_pass(shape,
                                                                      nsw)


@pytest.mark.parametrize("D,blk", [(48, 16), (40, 16), (9, 16), (64, 32),
                                   (35, 8), (256, 16)])
def test_item_plan_covers_every_plane_once(D, blk):
    """Every output plane is streamed by exactly one work item, and no item
    crosses its z-block's end."""
    plan = item_plan(D, blk)
    planes = [z for items in plan for pl, _, _ in items for z in pl]
    assert sorted(planes) == list(range(D))
    for k, items in enumerate(plan):
        assert all(k * blk <= z < (k + 1) * blk for pl, _, _ in items
                   for z in pl)


@pytest.mark.parametrize("D,blk", [(48, 16), (40, 16), (9, 16), (64, 32),
                                   (35, 8), (256, 16)])
def test_item_plan_stages_each_window_plane_once(D, blk):
    """Per z-block, its items together stage every window plane that no
    output reads (a's planes 1..hb-1 of each window, all of b's) exactly
    once and read a's first planes lo and hi; counted once a z-block, the
    planned bytes are the tool's window bytes of both inputs."""
    H, W = 3, 8
    lo, hi = window_planes(D, blk)
    plan, planned = item_plan(D, blk), 0
    for k, items in enumerate(plan):
        zl, zh = int(lo[k * blk]), int(hi[k * blk])
        staged = [e for _, st, _ in items for e in st]
        want = [(op, z) for zw in (zl, zh) for z in range(zw, min(zw + HB, D))
                for op in "ab" if (op, z) != ("a", zw)]
        assert sorted(staged) == sorted(want)
        assert {lohi for _, _, lohi in items} == {(zl, zh)}
        planned += len(staged) + 2
    assert len(plan) == -(-D // blk)
    assert planned * H * W * 4 == 2 * exp_hbm.window_bytes((D, H, W), blk)


def test_item_plan_is_the_kernels():
    """The plan's block tile and item depth are csrc/hbm.cu's."""
    src = (Path(hbm.__file__).parents[1] / "csrc" / "hbm.cu").read_text()
    tx, ty = (int(x) for x in re.search(
        r"constexpr int kTx = (\d+), kTy = (\d+);", src).groups())
    group = int(re.search(r"constexpr int kGroup = (\d+);", src).group(1))
    assert (tx, ty) == TILE and group == ITEM


@pytest.mark.parametrize("shape,blk,vec,want", [
    ((256, 256, 256), 16, 4, 2 * 32 * 16 * 4),
    ((256, 256, 256), 32, 4, 2 * 32 * 8 * 8),
    ((40, 8, 16), 16, 1, 1 * 1 * 3 * 4),
    ((9, 7, 13), 3, 1, 1 * 1 * 3 * 1)])
def test_stream_items_are_plane_groups_of_tiles(shape, blk, vec, want):
    """The grid: tiles of 32*vec x 8 cells, z-blocks, 4-plane groups; at
    256^3 the same items at blk 16 and 32."""
    assert stream_items(shape, blk, vec) == want


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
