"""The DMA-issue probe's stream (``kernels/dma.py``, ROADMAP B23) and the
probe ``fluid_simulation_tpu_torch/tools/exp_dma.py`` on the CPU.

The JAX kernel bodies are closures inside ``main()`` of
``tools/exp_dma.py`` (:31) and cannot be imported, so this file restates
each as a ``pl.pallas_call(..., interpret=True)`` with the tool's own
bodies, BlockSpec index maps (:83-93) and, for ``manual2``, its
double-buffered ``make_async_copy`` ring with DMA semaphores (:123-152),
and holds ``dma_stream_plain`` to it in f32 and bf16 at blk 8 and 16.
(W, H, D) = (16, 8, 48) divides into whole z-blocks (every form, TMA
legal: W a multiple of 8); (13, 7, 40) is odd, its last 16-plane block
half full (copy2, copy2h: the ldg loader's ragged shape).

f32 is bitwise. In bf16 torch rounds every add to bf16, as the card's
kernel does; XLA on the CPU may keep ``alo[0] + ahi[0]`` or ``a + b`` in
f32 before the last add, which moves the result by at most one bf16 ulp
of the result (BF16_ULPS).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, _build, dma as kdma, reset_launches)
from fluid_simulation_tpu_torch.kernels.dma import (
    HB, dma_stream, dma_stream_plain, loaders, manual_walk)
from fluid_simulation_tpu_torch.tools import exp_dma

torch.set_num_threads(1)

BF16_ULPS = 1
EVEN, ODD = (16, 8, 48), (13, 7, 40)
TINY = ["--device", "cpu", "--shape", "16", "8", "48", "--n", "2"]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_form(form, c, r, blk, hb=HB):
    """The tool's body ``form`` over (D, H, W) ``c`` and ``r`` as its
    pallas_calls run it, in interpret mode (exp_dma.py:74-155)."""
    D, H, W = c.shape
    nblk, nhb = -(-D // blk), -(-D // hb)
    mid = pl.BlockSpec((blk, H, W), lambda k: (k, 0, 0))
    lo = pl.BlockSpec((hb, H, W),
                      lambda k: (jnp.maximum(k * (blk // hb) - 1, 0), 0, 0))
    hi = pl.BlockSpec((hb, H, W),
                      lambda k: (jnp.minimum(k * (blk // hb) + blk // hb,
                                             nhb - 1), 0, 0))
    out_shape = jax.ShapeDtypeStruct(c.shape, c.dtype)

    def k2(a_ref, b_ref, o_ref):                          # :95-96
        o_ref[...] = a_ref[...] + b_ref[...]

    def k2h(alo, a, ahi, blo, b, bhi, o_ref):             # :105-106
        o_ref[...] = (a[...] + b[...]) + (alo[0] + ahi[0])

    E = blk + 2 * hb

    def kman(a_hbm, b_hbm, o_ref, asc, bsc, sems):        # :123-152
        k = pl.program_id(0)
        nb = pl.num_programs(0)

        def start(slot, kk):
            st = jnp.clip(kk * blk - hb, 0, D - E)
            pltpu.make_async_copy(a_hbm.at[pl.ds(st, E)], asc.at[slot],
                                  sems.at[slot, 0]).start()
            pltpu.make_async_copy(b_hbm.at[pl.ds(st, E)], bsc.at[slot],
                                  sems.at[slot, 1]).start()

        @pl.when(k == 0)
        def _():
            start(0, 0)

        @pl.when(k + 1 < nb)
        def _():
            start((k + 1) % 2, k + 1)

        slot = k % 2
        st = jnp.clip(k * blk - hb, 0, D - E)
        pltpu.make_async_copy(a_hbm.at[pl.ds(st, E)], asc.at[slot],
                              sems.at[slot, 0]).wait()
        pltpu.make_async_copy(b_hbm.at[pl.ds(st, E)], bsc.at[slot],
                              sems.at[slot, 1]).wait()
        off = k * blk - st
        o_ref[...] = (asc[slot, pl.ds(off, blk)]
                      + bsc[slot, pl.ds(off, blk)])

    a, b = jnp.asarray(c), jnp.asarray(r)
    if form == "copy2":
        call = pl.pallas_call(k2, grid=(nblk,), in_specs=[mid, mid],
                              out_specs=mid, out_shape=out_shape,
                              interpret=True)
        return call(a, b)
    if form == "copy2h":
        call = pl.pallas_call(k2h, grid=(nblk,), in_specs=[lo, mid, hi] * 2,
                              out_specs=mid, out_shape=out_shape,
                              interpret=True)
        return call(a, a, a, b, b, b)
    call = pl.pallas_call(
        kman, grid=(nblk,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2, out_specs=mid,
        scratch_shapes=[pltpu.VMEM((2, E, H, W), c.dtype),
                        pltpu.VMEM((2, E, H, W), c.dtype),
                        pltpu.SemaphoreType.DMA((2, 2))],
        out_shape=out_shape, interpret=True)
    return call(a, b)


def _inputs(shape, dtype, seed=3):
    W, H, D = shape
    rng = np.random.default_rng(seed)
    c, r = (torch.tensor(rng.normal(size=(D, H, W)).astype(np.float32))
            .to(dtype) for _ in range(2))
    return c, r


CASES = [(form, shape, blk, dtype)
         for dtype in kdma.DTYPES for blk in (8, 16)
         for form, shapes in (("copy2", (EVEN, ODD)), ("copy2h", (EVEN, ODD)),
                              ("manual2", (EVEN,)))
         for shape in shapes]


@pytest.mark.parametrize("form,shape,blk,dtype", CASES)
def test_plain_matches_the_jax_body(form, shape, blk, dtype):
    c, r = _inputs(shape, dtype)
    want = np.asarray(jax_form(form, c.float().numpy().astype(JNP[dtype]),
                               r.float().numpy().astype(JNP[dtype]), blk)
                      .astype(jnp.float32))
    for loader in loaders(form):
        if loader == "tma" and shape == ODD:
            continue
        got = dma_stream_plain(c, r, form=form, blk=blk, loader=loader)
        assert got.dtype == dtype and got.shape == c.shape
        got = got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_array_equal(got, want)
        else:
            # one bf16 ulp of the result: 2^(exponent - 7)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert np.all(np.abs(got - want) <= BF16_ULPS * ulp)
        # the wrapper takes the plain version on the CPU
        assert torch.equal(dma_stream(c, r, form=form, blk=blk,
                                      loader=loader).float(),
                           torch.tensor(got))


def test_bf16_rounds_every_add():
    """bf16 adds round one by one: 1 + 2^-8 is a tie that rounds to 1, so
    copy2 of a = 1 and b = 2^-8 is 1, and copy2h is (1) + (1 + 1) = 3."""
    a = torch.ones((8, 1, 8), dtype=torch.bfloat16)
    b = torch.full_like(a, 2.0 ** -8)
    assert torch.equal(dma_stream_plain(a, b, form="copy2", blk=8), a)
    assert torch.equal(dma_stream_plain(a, b, form="copy2h", blk=8), a * 3)


@pytest.mark.parametrize("kw,match", [
    (dict(shape=(48, 8, 13), form="copy2", loader="tma"), "16-byte rows"),
    (dict(shape=(48, 8, 12), form="copy2h", loader="tma",
          dtype=torch.bfloat16), "16-byte rows"),
    (dict(shape=(40, 8, 16), form="manual2"), "D % blk"),
    (dict(shape=(8, 8, 16), form="manual2", blk=8), "D >= blk"),
    (dict(shape=(48, 8, 16), form="manual2", loader="ldg"), "no 'ldg'"),
    (dict(shape=(48, 8, 16), form="copy3"), "form"),
    (dict(shape=(48, 8, 16), form="copy2", dtype=torch.float64),
     "float32 and bfloat16"),
    (dict(shape=(48, 8, 16), form="copy2h", blk=9), "divide"),
    (dict(shape=(48, 8, 16), form="manual2", blk=128), "shared memory"),
    (dict(shape=(48, 8, 16), form="copy2", loader="lds"), "no 'lds'"),
])
def test_refused_forms_raise_on_every_device(kw, match):
    kw = dict(kw)
    a = torch.zeros(kw.pop("shape"), dtype=kw.pop("dtype", torch.float32))
    kw.setdefault("blk", 16)
    for fn in (dma_stream, dma_stream_plain):
        with pytest.raises(ValueError, match=match):
            fn(a, a.clone(), **kw)


@pytest.mark.parametrize("shape,blk,esize,want", [
    ((256, 256, 256), 16, 4, 16),    # 128 tiles fill the card: one column
    ((256, 256, 256), 16, 2, 8),     # 64 bf16 tiles: two chunks
    ((256, 256, 256), 8, 4, 16),     # two 96 KB blocks an SM: two chunks
    ((48, 8, 16), 8, 4, 1),          # one tile: a z-block a block
])
def test_manual_walk_fills_the_card(shape, blk, esize, want):
    assert manual_walk(shape, blk, HB, esize, sms=132) == want


def test_probe_runs_its_rows_on_the_cpu(capsys):
    assert exp_dma.main(list(TINY)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    names = [ln.split()[0] for ln in lines[1:]]
    want = [f"{form}{tag}[{loader}]" for tag in ("", "_bf16")
            for blk in (8, 16) for form in kdma.FORMS
            for loader in loaders(form)]
    assert [n for n in names] == want
    assert all(ln.endswith("(host clock; no rate)") for ln in lines[1:])


def test_probe_rows_compute_their_forms():
    rows = exp_dma.rows("cpu", (16, 8, 48), blks=(8,))
    c = rows[0].x0
    r = exp_dma.second_operand(c)
    assert torch.equal(rows[0].step(c), c + r)
    assert rows[0].units == 3 and rows[1].units == 3 and \
        rows[2].units == 3 + 4 * HB / 8
    assert [row.issues for row in rows[:5]] == [
        "2 loads/thread/plane, 8 in flight, any blk",
        "2 boxes/plane, any blk", "24 loads/thread", "6 boxes", "2 boxes"]


def test_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_dma.main(["--n", "1"])


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; the launcher is a stub that
    checks what the kernel would be given and writes the plain result."""
    calls = []

    def stub(a, b, out, form, blk, loader, hb):
        assert a.is_contiguous() and b.is_contiguous()
        assert a.dtype == b.dtype == out.dtype and out.shape == a.shape
        assert len({a.data_ptr(), b.data_ptr(), out.data_ptr()}) == 3
        calls.append((form, loader))
        out.copy_(dma_stream_plain(a, b, form=form, blk=blk, loader=loader,
                                   hb=hb))

    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(kdma, "_launch", stub)
    reset_launches()
    yield calls
    reset_launches()


@pytest.mark.parametrize("form", kdma.FORMS)
def test_every_form_is_one_launch(card, form):
    c, r = _inputs(EVEN, torch.bfloat16)
    for loader in loaders(form):
        got = dma_stream(c, r, form=form, blk=8, loader=loader)
        assert torch.equal(got, dma_stream_plain(c, r, form=form, blk=8))
    assert LAUNCHES["dma_stream"] == len(loaders(form))
    assert card == [(form, ld) for ld in loaders(form)]
    with pytest.raises(ValueError, match="operands of"):
        dma_stream(c, r.float(), form=form, blk=8)
    assert LAUNCHES["dma_stream"] == len(loaders(form))


# ---- copy2's work items and grid, shared memory; the tensor-map cache

def _cdiv(a, b):
    return -(-a // b)


def _items(shape, blk, loader, esize):
    """(tile, first plane, planes) of each copy2 work item in the order
    dma.cu's ``Items::at`` numbers them."""
    D, H, W = shape
    if loader == "tma":
        tx, ty, group = kdma.TMA_ROW_BYTES // esize, kdma.TMA_ROWS, \
            kdma.TMA_GROUP
    else:
        tx, ty, group = kdma.LDG_TILE[0] * kdma.ldg_vec(W, esize), \
            kdma.LDG_TILE[1], kdma.LDG_PLANES
    tiles = _cdiv(W, tx) * _cdiv(H, ty)
    groups = _cdiv(blk, group)
    total = tiles * _cdiv(D, blk) * groups
    for q in range(total):
        tile, zg = q % tiles, q // tiles
        zb, g = divmod(zg, groups)
        z0 = zb * blk + g * group
        yield tile, z0, min(group, blk - g * group, D - z0)


ITEM_CASES = [(shape, blk, loader, dtype)
              for shape in ((256, 256, 256), (48, 8, 16), (40, 7, 13),
                            (37, 9, 72), (48, 19, 200))
              for blk in (3, 8, 16) for loader in kdma.LOADERS
              for dtype in kdma.DTYPES
              if loader == "ldg" or shape[2] * dtype.itemsize % 16 == 0]


@pytest.mark.parametrize("shape,blk,loader,dtype", ITEM_CASES)
def test_copy2_items_cover_every_plane_once(shape, blk, loader, dtype):
    """Each tile's planes are covered once by its items, and no item
    crosses a z-block's end; ``copy2_items`` counts them all (items past
    the last plane of a ragged z-block included: they move nothing)."""
    esize = dtype.itemsize
    items = list(_items(shape, blk, loader, esize))
    assert kdma.copy2_items(shape, blk, loader, esize) == len(items)
    covered = {}
    for tile, z0, n in items:
        if n <= 0:
            continue
        assert z0 // blk == (z0 + n - 1) // blk
        for z in range(z0, z0 + n):
            covered[tile, z] = covered.get((tile, z), 0) + 1
    tiles = max(t for t, _, _ in items) + 1
    assert covered == {(t, z): 1 for t in range(tiles)
                       for z in range(shape[0])}


@pytest.mark.parametrize("loader,dtype,want", [
    ("tma", torch.float32, 32768), ("tma", torch.bfloat16, 16384),
    ("ldg", torch.float32, 4096), ("ldg", torch.bfloat16, 2048)])
@pytest.mark.parametrize("blk", [8, 16])
def test_copy2_items_at_256_cubed(loader, dtype, want, blk):
    """One item a tile plane (TMA) or a tile's 4 planes (ldg), whatever
    blk is: the same work at blk 8 and 16."""
    assert kdma.copy2_items((256, 256, 256), blk, loader,
                            dtype.itemsize) == want


@pytest.mark.parametrize("shape,blk,loader,dtype", ITEM_CASES[::3])
def test_copy2_launch_has_one_block_an_item(monkeypatch, shape, blk, loader,
                                            dtype):
    """The real ``_launch`` (the library call stubbed) gives copy2's
    kernel a grid of one block a work item, the ldg loader's vector width,
    and TMA maps of a and b only (one plane deep); the kernel refuses any
    other grid."""
    got = {}
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: got.update(args=args))
    monkeypatch.setattr(kdma, "tensor_map",
                        lambda t, planes: None if planes is None else
                        (t.data_ptr(), planes))
    a, b = (torch.zeros(shape, dtype=dtype) for _ in range(2))
    out = torch.empty_like(a)
    kdma._launch(a, b, out, "copy2", blk, loader, HB)
    maps, rest = got["args"][3:7], got["args"][7:]
    D, H, W = shape
    vec = kdma.ldg_vec(W, dtype.itemsize)
    assert rest == (D, H, W, int(dtype == torch.bfloat16), 0,
                    int(loader == "tma"), blk, HB, 1, vec,
                    kdma.copy2_items(shape, blk, loader, dtype.itemsize))
    want = ([(a.data_ptr(), 1), None, (b.data_ptr(), 1), None]
            if loader == "tma" else [None] * 4)
    assert list(maps) == want


def test_tma_shared_memory_sizes():
    """copy2's two one-plane boxes take the same 4 KB whatever blk is, so
    an SM's 16 blocks of 128 threads fit; copy2h's windows and manual2's
    slots grow with blk."""
    boxes = 2 * kdma.TMA_GROUP * 2048 + 128
    assert {kdma.tma_smem("copy2", blk) for blk in (1, 8, 16, 64)} == {boxes}
    assert 233472 // (boxes + 1024) >= 2048 // 128
    assert kdma.tma_smem("copy2h", 16) == (32 + 8) * 2048 + 128
    assert kdma.tma_smem("manual2", 16) == 4 * 20 * 2048 + 128


def test_map_key_differs_for_two_tensors_of_one_shape():
    a, b = torch.zeros(48, 8, 16), torch.zeros(48, 8, 16)
    assert kdma.map_key(a, 1) != kdma.map_key(b, 1)
    assert kdma.map_key(a, 1) == kdma.map_key(a.view(48, 8, 16), 1)
    assert kdma.map_key(a, 1) != kdma.map_key(a, 2)
    assert kdma.map_key(a, 1) != kdma.map_key(a.view(48, 16, 8), 1)
    assert kdma.map_key(a, 1) != kdma.map_key(
        a.view(torch.bfloat16)[..., :16], 1)
    assert kdma.map_planes("copy2", 16) == (kdma.TMA_GROUP, None)
    assert kdma.map_planes("copy2h", 16) == (16, HB)
    assert kdma.map_planes("manual2", 16) == (16 + 2 * HB, None)
    assert kdma._encoded.cache_info().maxsize == kdma.MAP_CACHE
