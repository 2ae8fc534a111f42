"""The big-grid route's plain torch versions (``kernels/linsolve_stream.py``,
``kernels/project_stream.py``) against the JAX package's streamed Pallas
kernels, run as the JAX suite runs them on the CPU (``interpret=True``), and
against the port's resident plain versions. The CUDA kernels themselves are
held to these plain versions on the card by ``chip_smoke.py``.

Tolerances. Torch rounds every product and sum on its own; the Pallas
interpreter and XLA's CPU compiler contract some ``a*b + c`` into fused
multiply-adds (the solve's ``rhs + a*s``, the gradient subtraction). So the
solves and the projections agree with the JAX kernels to 1e-6 on O(1)
values: the bound of the port's resident K1/K2 tests
(``tests/test_torch_kernels.py``) and the JAX suite's own for its streamed
projections against its composable path (``tests/test_kernels.py:325-329``).
Against the port's resident plains (the route the 128x64x64 class keeps)
the streamed solve and projection are bitwise equal in value, on states
the step makes (ghost edges zero, velocities zero in solid cells).
"""

import re
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu.config import SimParams as JaxSimParams
from fluid_simulation_tpu.kernels.linsolve_mdma import pallas_rbgs_solve_mdma
from fluid_simulation_tpu.kernels.linsolve_stream import (
    pallas_rbgs_solve_stream_t)
from fluid_simulation_tpu.kernels.linsolve_temporal import (
    pallas_rbgs_solve_temporal)
from fluid_simulation_tpu.kernels.project_stream import (
    pallas_project_stream_masked, pallas_project_stream_packed)
from fluid_simulation_tpu.models.windtunnel import (
    _pad_bounds_tail as jax_pad_bounds_tail)
from fluid_simulation_tpu.scene.masks import build_masks as jax_build_masks
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch.kernels.bounds import pad_bounds_plain
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve_plain
from fluid_simulation_tpu_torch.kernels import linsolve_stream
from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    MARCH_CHUNK, MARCH_TILE, face_block, march_geometry, march_pass,
    pass_plain, rbgs_solve_stream_plain, sweep1_plain)
from fluid_simulation_tpu_torch.kernels.project import (
    project_empty_plain, project_masked_plain)
from fluid_simulation_tpu_torch.kernels.project_stream import (
    project_stream_masked_plain, project_stream_plain)
from fluid_simulation_tpu_torch.kernels.sweepcost import (
    VARIANTS, sweep_pass_variant_plain)
from fluid_simulation_tpu_torch.scene.masks import build_masks
from fluid_simulation_tpu_torch.tools import exp_pass

torch.set_num_threads(1)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(dims, kind):
    W, H, D = dims
    if kind == "empty":
        return empty_obstacles(W, H, D)
    if kind == "sphere":
        return add_sphere(empty_obstacles(W, H, D), W // 2, H // 2, D // 2,
                          2.4)
    rng = np.random.default_rng(17)
    obs = empty_obstacles(W, H, D)
    obs[1:-1, 1:-1, 1:-1] = rng.uniform(size=(D, H, W)) < 0.2
    return obs


# the merged-window solve's cases (tests/test_kernels.py:664-670): nsw 1, 2
# and 3, remainder passes, empty and sphere, both wall modes, b 0-3
MDMA_CASES = [
    ((16, 8, 8), 4, 2, False, "reference", 2, 6),
    ((16, 8, 8), 4, 1, False, "reference", 1, 6),
    ((16, 8, 8), 2, 1, True, "noslip", 3, 5),
    ((16, 8, 12), 4, 2, True, "reference", 0, 6),
    ((16, 8, 12), 6, 3, False, "reference", 0, 7),
    ((16, 8, 20), 4, 2, False, "reference", 2, 9),
]


@pytest.mark.parametrize("dims,blk,nsw,empty,wall,b,acc", MDMA_CASES)
def test_solve_stream_matches_mdma(dims, blk, nsw, empty, wall, b, acc):
    W, H, D = dims
    obs = _scene(dims, "empty" if empty else "sphere")
    jm, tm = jax_build_masks(np.asarray(obs, np.float32)), build_masks(
        obs, device=CPU)
    rng = np.random.default_rng(3 + b + acc)
    f, g = (rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
            for _ in range(2))
    want = pallas_rbgs_solve_mdma(
        b, jnp.asarray(f), jnp.asarray(g), jm.keep_vel if b else jm.keep_scalar,
        0.9, 6.4, acc=acc, wall_mode=wall, empty_scene=empty, blk=blk,
        nsw=nsw, interpret=True)
    keep = None if empty else (tm.keep_vel if b else tm.keep_scalar)
    got = rbgs_solve_stream_plain(b, _t(f), _t(g), 0.9, 6.4, acc, wall, keep,
                                  nsw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # and the resident route's plain version, bit for bit
    assert torch.equal(got, rbgs_solve_plain(b, _t(f), _t(g), 0.9, 6.4, acc,
                                             wall, keep))


def _random_keep(shape, rng):
    keep = np.ones(shape, np.float32)
    sol = rng.random(size=tuple(n - 2 for n in shape)) < 0.2
    keep[1:-1, 1:-1, 1:-1] = (~sol).astype(np.float32)
    return keep


@pytest.mark.parametrize("shape,b,empty,acc,blk,ksw", [
    ((18, 6, 10), 0, False, 9, 8, 2),       # tests/test_kernels.py:625-629
    ((34, 6, 10), 2, False, 15, 16, 4)])
def test_solve_stream_matches_stream_t(shape, b, empty, acc, blk, ksw):
    """The temporal BlockSpec solve (B11), ``ksw`` sweeps per pass; the port
    runs the same sweeps at its own depth, 2."""
    rng = np.random.default_rng(11)
    field, prev = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(2))
    keep = _random_keep(shape, rng)
    want = pallas_rbgs_solve_stream_t(
        b, jnp.asarray(field), jnp.asarray(prev), jnp.asarray(keep), 0.3, 2.8,
        acc=acc, interpret=True, empty_scene=empty, blk=blk, ksw=ksw)
    got = rbgs_solve_stream_plain(b, _t(field), _t(prev), 0.3, 2.8, acc,
                                  keep=_t(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("b,kw,blkp", [
    (2, dict(wall_mode="noslip"), (6, 6, 2)),   # tests/test_kernels.py:229-237
    (0, dict(acc=7), (8, 8, 3))])               # remainder pass (7 = 2*3 + 1)
def test_solve_stream_matches_temporal(b, kw, blkp):
    """The padded-layout temporal solve (B12), the wrapper's function in
    another layout."""
    W, H, D = 16, 8, 8
    obs = add_sphere(empty_obstacles(W, H, D), W // 3, H // 2, D // 2, 2.5)
    jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs, device=CPU)
    rng = np.random.default_rng(0)
    f, g = (rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
            for _ in range(2))
    acc, wall = kw.get("acc", 6), kw.get("wall_mode", "reference")
    blk, hb, ksw = blkp
    want = pallas_rbgs_solve_temporal(
        b, jnp.asarray(f), jnp.asarray(g), jm.keep_vel if b else jm.keep_scalar,
        1.0, 6.0, acc=acc, wall_mode=wall, interpret=True, blk=blk, hb=hb,
        ksw=ksw)
    got = rbgs_solve_stream_plain(b, _t(f), _t(g), 1.0, 6.0, acc, wall,
                                  tm.keep_vel if b else tm.keep_scalar)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _step_like_fields(shape, seed):
    """Random velocities with zero ghost edges and corners, as in any real
    run (tests/test_kernels.py:305-313)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.float32)
    m[1:-1, 1:-1, :] = 1.0
    m[1:-1, :, 1:-1] = 1.0
    m[:, 1:-1, 1:-1] = 1.0
    return [rng.normal(size=shape).astype(np.float32) * m for _ in range(3)]


# the blocks and walls of tests/test_kernels.py:288-369
@pytest.mark.parametrize("wall_mode,blk", [
    ("reference", 8), ("noslip", 8), ("reference", 4)])
@pytest.mark.parametrize("kind", ["empty", "sphere"])
def test_project_stream_matches_pallas(wall_mode, blk, kind):
    W, H, D = 16, 8, 8
    obs = (empty_obstacles(W, H, D) if kind == "empty" else
           add_sphere(empty_obstacles(W, H, D), W // 3, H // 2, D // 2, 2.5))
    jm, tm = jax_build_masks(jnp.asarray(obs)), build_masks(obs, device=CPU)
    vel = _step_like_fields((D + 2, H + 2, W + 2), 13 if kind == "empty"
                            else 29)
    empty = kind == "empty"
    jp = JaxSimParams(width=W, height=H, depth=D, empty_scene=empty,
                      wall_mode=wall_mode)
    jv = [jnp.asarray(v) for v in vel]
    if empty:
        smp = pallas_project_stream_packed(*jv, acc=5, wall_mode=wall_mode,
                                           interpret=True, blk=blk)
        got = project_stream_plain(*map(_t, vel), acc=5, wall_mode=wall_mode)
        tail = pad_bounds_plain(got, (1, 2, 3), wall_mode)
    else:
        smp = pallas_project_stream_masked(*jv, jm.fluid_i, acc=5,
                                           wall_mode=wall_mode,
                                           interpret=True, blk=blk)
        got = project_stream_masked_plain(*map(_t, vel), tm.fluid_i, acc=5,
                                          wall_mode=wall_mode)
        tail = pad_bounds_plain(got, (1, 2, 3), wall_mode, tm.fluid_i,
                                tm.keep_vel[1:-1, 1:-1, 1:-1])
    want = jax_pad_bounds_tail(smp, (1, 2, 3), jm, jp)
    for i in range(3):
        np.testing.assert_allclose(tail[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=1e-6,
                                   err_msg=f"component {i} blk={blk}")


@pytest.mark.parametrize("kind,dims", [("empty", (16, 8, 8)),
                                       ("sphere", (16, 8, 8)),
                                       ("random", (13, 7, 10))])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_project_stream_equals_resident(kind, dims, wall_mode):
    """The streamed projection plus the pad_bounds tail equals the resident
    projection (K2 / K6) on a step-like state, bit for bit in value."""
    W, H, D = dims
    tm = build_masks(_scene(dims, kind), device=CPU)
    vel = [_t(v) * tm.keep_scalar
           for v in _step_like_fields((D + 2, H + 2, W + 2), 31)]
    if kind == "empty":
        want = project_empty_plain(*vel, acc=15, wall_mode=wall_mode)
        got = pad_bounds_plain(project_stream_plain(
            *vel, acc=15, wall_mode=wall_mode), (1, 2, 3), wall_mode)
    else:
        kv = tm.keep_vel[1:-1, 1:-1, 1:-1]
        want = project_masked_plain(*vel, tm.fluid_i, kv, acc=15,
                                    wall_mode=wall_mode)
        got = pad_bounds_plain(project_stream_masked_plain(
            *vel, tm.fluid_i, acc=15, wall_mode=wall_mode), (1, 2, 3),
            wall_mode, tm.fluid_i, kv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nsw,acc", [(1, 4), (2, 15), (2, 6), (3, 8)])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_solve_stream_equals_resident(nsw, acc, wall_mode):
    """Every field tag, empty and keep, random 0/1 solids on an odd grid
    whose depth no pass divides: bitwise to the resident plain solve."""
    W, H, D = 13, 7, 10
    tm = build_masks(_scene((W, H, D), "random"), device=CPU)
    rng = np.random.default_rng(nsw * 100 + acc)
    f, g = (_t(rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32))
            for _ in range(2))
    for b in range(4):
        for keep in (None, tm.keep_vel if b else tm.keep_scalar):
            want = rbgs_solve_plain(b, f, g, 0.7, 5.2, acc, wall_mode, keep)
            got = rbgs_solve_stream_plain(b, f, g, 0.7, 5.2, acc, wall_mode,
                                          keep, nsw)
            assert torch.equal(got, want), (b, keep is None)


# The pass kernel's z-march (csrc/rbgs_tile.cuh), emulated step by step in
# its own layout (linsolve_stream.march_pass): D under the ring and the
# warm-up (1, 2, 3, 5), a D one past a z-range, H and W under the tile,
# tiles with face and interior blocks, short z-ranges (chunk 4) so that
# several blocks march one column, nsw 1 and 2, keep and empty, b 0-3 and
# both walls; the last two, nsw 2 with keep on several blocks in x, y and
# z. (W, H, D), nsw, keep, wall, b, chunk
MARCH_CASES = [
    ((13, 7, 1), 1, False, "reference", 1, MARCH_CHUNK),
    ((13, 7, 1), 2, True, "noslip", 2, MARCH_CHUNK),
    ((13, 7, 2), 1, True, "noslip", 3, MARCH_CHUNK),
    ((13, 7, 2), 2, False, "reference", 0, MARCH_CHUNK),
    ((13, 7, 3), 1, False, "noslip", 2, MARCH_CHUNK),
    ((13, 7, 3), 2, True, "reference", 1, MARCH_CHUNK),
    ((13, 7, 5), 1, True, "reference", 0, MARCH_CHUNK),
    ((13, 7, 5), 2, False, "noslip", 3, MARCH_CHUNK),
    ((9, 13, MARCH_CHUNK + 1), 2, True, "noslip", 1, MARCH_CHUNK),
    ((9, 13, MARCH_CHUNK + 1), 1, False, "reference", 2, MARCH_CHUNK),
    ((80, 70, 6), 2, True, "reference", 1, MARCH_CHUNK),
    ((80, 70, 6), 1, False, "noslip", 3, MARCH_CHUNK),
    ((70, 36, 11), 2, False, "reference", 2, 4),
    ((70, 36, 11), 1, True, "noslip", 0, 4),
    ((37, 21, 9), 2, True, "noslip", 3, 4),
    ((37, 21, 9), 1, True, "reference", 1, 3),
    ((70, 40, 9), 2, True, "reference", 2, 4),
    ((66, 36, 10), 2, True, "noslip", 0, 3),
]


def _march_inputs(dims, keep, b, seed):
    """A carry, an interior rhs view and (with ``keep``) the interior of
    the keep mask a random 0/1 scene gives field ``b``, as numpy."""
    W, H, D = dims
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(D, H, W)).astype(np.float32)
    g = rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
    kv = None
    if keep:
        tm = build_masks(_scene(dims, "random"), device=CPU)
        kv = (tm.keep_vel if b else tm.keep_scalar)[1:-1, 1:-1, 1:-1]
    return f, g, kv


@pytest.mark.parametrize("dims,nsw,keep,wall,b,chunk", MARCH_CASES)
def test_march_equals_pass_plain(dims, nsw, keep, wall, b, chunk):
    """The z-march's plan, bit for bit the plain pass."""
    f, g, kv = _march_inputs(dims, keep, b, sum(dims) + nsw)
    rhs = g[1:-1, 1:-1, 1:-1]
    want = pass_plain(_t(f), _t(rhs), kv, b, 0.7, 5.2, nsw, wall)
    got = march_pass(f, rhs, None if kv is None else kv.numpy(), b, 0.7,
                     5.2, nsw, wall, chunk=chunk)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("dims,chunk", [
    ((13, 7, 1), MARCH_CHUNK), ((13, 7, 2), MARCH_CHUNK),
    ((13, 7, 3), MARCH_CHUNK), ((13, 7, 5), MARCH_CHUNK),
    ((9, 13, MARCH_CHUNK + 1), MARCH_CHUNK), ((80, 70, 6), MARCH_CHUNK),
    ((37, 21, 9), 4)])
def test_march_sweep1_equals_sweep1_plain(dims, chunk):
    """Sweep 1's march on the padded field (ghost planes -1 and D and the
    ghost rows and columns read, never spliced), bit for bit."""
    _, g, _ = _march_inputs(dims, False, 0, sum(dims))
    field = np.random.default_rng(len(dims)).normal(
        size=g.shape).astype(np.float32)
    rhs = g[1:-1, 1:-1, 1:-1]
    want = sweep1_plain(_t(field), _t(rhs), 0.9, 6.4)
    got = march_pass(field, rhs, None, 0, 0.9, 6.4, 1, padded=True,
                     chunk=chunk)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("variant", VARIANTS)
def test_march_variants_equal_their_plain_versions(variant, nsw):
    """The sweep-cost variants on the march (csrc/sweepcost.cu), each bit
    for bit its stated function, at a shape with face and interior
    blocks and two z-ranges."""
    f, g, _ = _march_inputs((80, 70, 7), False, 1, nsw)
    rhs = g[1:-1, 1:-1, 1:-1]
    want = sweep_pass_variant_plain(_t(f), _t(rhs), variant, nsw, 1, 1e-4,
                                    1.0006)
    got = march_pass(f, rhs, None, 1, 1e-4, 1.0006, nsw, variant=variant,
                     chunk=4)
    np.testing.assert_array_equal(got, want.numpy())


def _brute_table(shape, nsw, cells, chunk=MARCH_CHUNK):
    """The keep passes' table from its definition: every block whose
    footprint (ring planes of L x LY cells from (bx*tx - M, by*ty - M), on
    the planes [zs - M, ze + M - 1] it loads) holds one of ``cells``."""
    D, H, W = shape
    M, L, LY, _, _ = march_geometry(nsw)
    tx, ty = MARCH_TILE[nsw]
    gx, gy, gz = -(-W // tx), -(-H // ty), -(-D // chunk)
    table = np.zeros((gz, gy, gx), np.uint8)
    for z, y, x in cells:
        for bz in range(gz):
            zs, ze = bz * chunk, min(bz * chunk + chunk, D)
            if not zs - M <= z <= ze + M - 1:
                continue
            for by in range(gy):
                for bx in range(gx):
                    if (bx * tx - M <= x < bx * tx - M + L
                            and by * ty - M <= y < by * ty - M + LY):
                        table[bz, by, bx] = 1
    return table


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("dims,chunk", [
    ((13, 7, 5), MARCH_CHUNK), ((37, 21, 40), MARCH_CHUNK),
    ((101, 70, 35), MARCH_CHUNK), ((70, 36, 11), 4)])
def test_march_table_plain_is_the_footprint(dims, chunk, nsw):
    """``march_table_plain`` (the keep passes' table off the card) flags
    exactly the blocks whose footprint holds a keep other than 1, on grids
    off the tiles and the z-range, with a few solids and a 0.5 among ones,
    and flags none on a mask of ones."""
    W, H, D = dims
    rng = np.random.default_rng(sum(dims) + nsw)
    keep = np.ones((D, H, W), np.float32)
    cells = [tuple(int(rng.integers(n)) for n in (D, H, W))
             for _ in range(5)]
    for i, c in enumerate(cells):
        keep[c] = 0.5 if i == 0 else 0.0
    got = linsolve_stream.march_table_plain(_t(keep), nsw, chunk).numpy()
    want = _brute_table((D, H, W), nsw, cells, chunk)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size or want.size <= 4
    none = linsolve_stream.march_table_plain(_t(np.ones_like(keep)), nsw,
                                             chunk)
    assert not none.any()


def _halo_case(nsw, axis, side, chunk):
    """A grid of 4 x 4 x 4 blocks whose one solid (keep 0, a black cell)
    lies in block (1, 1, 1)'s halo alone, M = 2*nsw cells past its tile
    along ``axis`` on ``side``, and inside its tile and z-range along the
    other two axes. Returns (keep, the cell)."""
    M = 2 * nsw
    tx, ty = MARCH_TILE[nsw]
    W, H, D = 3 * tx + 5, 3 * ty + 3, 3 * chunk + M + 1
    cell = {"x": tx + 3, "y": ty + 2, "z": chunk + 1}
    lo = {"x": tx, "y": ty, "z": chunk}
    span = {"x": tx, "y": ty, "z": chunk}
    cell[axis] = lo[axis] - M if side == "low" else lo[axis] + span[axis] \
        + M - 1
    z, y, x = cell["z"], cell["y"], cell["x"]
    if (x + y + z) & 1:                  # red: move it in y (tile-side)
        y += 1 if axis != "y" else 0
        x += 1 if axis == "y" else 0
    keep = np.ones((D, H, W), np.float32)
    keep[z, y, x] = 0.0
    return keep, (z, y, x)


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("side", ["low", "high"])
def test_march_keep_free_blocks_equal_pass_plain(nsw, axis, side):
    """The march with its table (``march_pass``): blocks whose byte is 0
    run the keep-free form, the rest the keep form, and the pass is bit
    for bit ``pass_plain``'s where one solid lies only in a block's halo,
    M cells from its tile in x, y or z. That block is flagged, and it has
    to be: with its byte cleared the pass differs."""
    chunk = 4
    keep, cell = _halo_case(nsw, axis, side, chunk)
    D, H, W = keep.shape
    tx, ty = MARCH_TILE[nsw]
    owner = (cell[0] // chunk, cell[1] // ty, cell[2] // tx)
    assert owner != (1, 1, 1) and sum(cell) % 2 == 0
    rng = np.random.default_rng(nsw * 31 + len(axis + side))
    f = rng.normal(size=(D, H, W)).astype(np.float32)
    rhs = rng.normal(size=(D, H, W)).astype(np.float32)
    table = linsolve_stream.march_table_plain(_t(keep), nsw, chunk).numpy()
    np.testing.assert_array_equal(table,
                                  _brute_table((D, H, W), nsw, [cell], chunk))
    assert table[1, 1, 1] and table[owner] and table.sum() < table.size
    want = pass_plain(_t(f), _t(rhs), _t(keep), 1, 0.7, 5.2, nsw).numpy()
    got = march_pass(f, rhs, keep, 1, 0.7, 5.2, nsw, chunk=chunk)
    np.testing.assert_array_equal(got, want)
    cleared = table.copy()
    cleared[1, 1, 1] = 0
    wrong = march_pass(f, rhs, keep, 1, 0.7, 5.2, nsw, chunk=chunk,
                       table=cleared)
    assert not np.array_equal(wrong, want)


def test_march_table_cache_follows_the_mask():
    """``march_table`` keeps one table a mask view and depth while the
    mask stays as it was: a new view of the same mask finds it, an
    in-place edit of the mask builds it anew, a mask that dies takes its
    tables with it, and an entry whose mask is another tensor is never
    returned, whatever its key."""
    tables = linsolve_stream._TABLES
    keep = torch.ones((13, 40, 72))
    view = lambda k: k[1:-1, 1:-1, 1:-1]           # noqa: E731
    t1, n1 = linsolve_stream.march_table(view(keep), 2)
    assert n1 == 0 and not t1.any()
    assert linsolve_stream.march_table(view(keep), 2)[0] is t1
    keep[5, 6, 7] = 0.0
    t2, n2 = linsolve_stream.march_table(view(keep), 2)
    assert t2 is not t1 and n2 == int(t2.sum()) > 0
    np.testing.assert_array_equal(
        t2.numpy(), _brute_table((11, 38, 70), 2, [(4, 5, 6)]))
    t3, n3 = linsolve_stream.march_table(view(keep), 1)
    assert t3.shape != t2.shape and n3 == int(t3.sum()) > 0
    assert linsolve_stream.march_table(view(keep), 2)[0] is t2
    mine = [k for k in tables if k[0] == id(keep)]
    assert len(mine) == 2
    del keep
    assert not any(k in tables for k in mine)
    # a new mask whose key an older mask's entry holds
    new = torch.ones((13, 40, 72))
    other = torch.zeros(1)
    key = (id(new), view(new).storage_offset(), (11, 38, 70),
           view(new).stride(), 2)
    tables[key] = (weakref.ref(other), new._version, t2, n2)
    t4, n4 = linsolve_stream.march_table(view(new), 2)
    assert t4 is not t2 and n4 == 0
    assert tables[key][0]() is new


def test_march_table_rebuilds_an_inference_mask():
    """A mask that is an inference tensor has no version to watch and may
    be edited in place under inference mode: its table is built at each
    call and follows the edit, and no entry of the cache holds it. The
    count comes back as a 0-d tensor beside the table."""
    with torch.inference_mode():
        keep = torch.ones((11, 38, 70))
        before = len(linsolve_stream._TABLES)
        t1, n1 = linsolve_stream.march_table(keep, 2)
        keep[4, 5, 6] = 0.0
        t2, n2 = linsolve_stream.march_table(keep, 2)
        assert len(linsolve_stream._TABLES) == before
    assert isinstance(n1, torch.Tensor) and n1.dim() == 0
    assert int(n1) == 0 and not t1.any()
    assert int(n2) == int(t2.sum()) > 0
    np.testing.assert_array_equal(
        t2.numpy(), _brute_table((11, 38, 70), 2, [(4, 5, 6)]))


def test_march_blocks_sums_its_tables_when_read():
    """``MARCH_BLOCKS`` holds each table's count as it was given and sums
    launches times counts when read; past ``HELD`` tables it folds them
    into host counts and still reads the same sums; ``reset_launches``
    empties it."""
    from fluid_simulation_tpu_torch.kernels import (
        MARCH_BLOCKS, reset_launches)
    reset_launches()
    try:
        three = torch.tensor(3)
        for _ in range(2):
            MARCH_BLOCKS.add(three, 10)
        assert MARCH_BLOCKS == {"keep_form": 6, "keep_free": 14}
        n = MARCH_BLOCKS.HELD + 5
        for i in range(n):
            MARCH_BLOCKS.add(torch.tensor(i % 2), 4)
        odd = n // 2
        assert len(MARCH_BLOCKS._tables) <= MARCH_BLOCKS.HELD
        assert dict(MARCH_BLOCKS) == {"keep_form": 6 + odd,
                                      "keep_free": 14 + 4 * n - odd}
        reset_launches()
        assert dict(MARCH_BLOCKS) == {"keep_form": 0, "keep_free": 0}
    finally:
        reset_launches()


def test_march_plan_is_the_kernels():
    """The plan's tiles, z-range and ring are rbgs_tile.cuh's constants, and
    the test shapes have face blocks and interior blocks where the tests
    need them."""
    src = (Path(linsolve_stream.__file__).parents[1] / "csrc"
           / "rbgs_tile.cuh").read_text()
    tx, chunk = (int(x) for x in re.search(
        r"constexpr int kTx = (\d+), kChunk = (\d+);", src).groups())
    ty1, ty2 = (int(x) for x in re.search(
        r"constexpr int kTy = NSW == 1 \? (\d+) : (\d+);", src).groups())
    assert MARCH_TILE == {1: (tx, ty1), 2: (tx, ty2)}
    assert chunk == MARCH_CHUNK
    assert "static constexpr int R = 2 * NSW + 3;" in src
    assert march_geometry(2)[4] == 7 and march_geometry(1)[4] == 5
    for nsw, interior in ((1, 3), (2, 1)):
        M, (tx, ty) = 2 * nsw, MARCH_TILE[nsw]
        faces = [face_block(bx * tx - M, by * ty - M, 70, 80, nsw)
                 for by in range(-(-70 // ty)) for bx in range(3)]
        assert faces.count(False) == interior and faces[0] and faces[-1]
        assert all(face_block(-M, -M, H, W, nsw) for H, W in ((7, 13),
                                                               (13, 9)))


# The keep forms' coalesced plane loads (rbgs_tile.cuh ``fetch`` and
# ``land``), as a NumPy model of who loads which word: quad owner t < NQ
# copies cells c = t + i*NQ (i = 0..3) of the L x LY ring plane in
# row-major order into word c // 2 of the half of the cell's parity, and
# warp t // 32's ballot of its copies' keep (black cells only) is word
# i*WPI + t // 32 of the slot's keep bits. The owner of quad t reads cells
# 4t .. 4t+3 as ``write`` lays them out, and in a red half the keep bits
# of its black neighbours at ``kpos`` and the offsets ``half`` gives them.


def _march_threads(nsw):
    """``(THREADS, NQ, WPI, HP)`` of the pass kernel's keep form at ``nsw``,
    as ``March`` and ``half_stride`` compute them."""
    _, L, LY, HW, _ = march_geometry(nsw)
    nq = LY * (HW // 2)
    threads = -(-nq // 32) * 32
    return threads, nq, threads // 32, -(-LY * HW // 32) * 32 + 16


def _load_plan(nsw, x0, y0, q, D, H, W):
    """Every copy one plane's ``fetch`` makes, as rows (i, t, c, row, lx,
    half, word, copied), in the order of (i, t): ``copied`` False where the
    ring holds a zero."""
    _, L, _, _, _ = march_geometry(nsw)
    _, nq, _, _ = _march_threads(nsw)
    face = face_block(x0, y0, H, W, nsw)
    plan = []
    for i in range(4):
        for t in range(nq):
            c = t + i * nq
            r, lx = divmod(c, L)
            gy, gx = y0 + r, x0 + lx
            ok = 0 <= q < D and (not face or (0 <= gx < W and 0 <= gy < H))
            plan.append((i, t, c, r, lx, (gx + gy + q) & 1, c >> 1, ok))
    return plan


def _owner_words(nsw, y0, q):
    """The (half, word) each cell's quad owner reads it from: cells 0 and 2
    of quad t at words f, f+1 (f = 2t) of half e = (y0 + row + q) & 1, cells
    1 and 3 at the same words of half e ^ 1."""
    _, L, _, HW, _ = march_geometry(nsw)
    _, nq, _, _ = _march_threads(nsw)
    want = {}
    for t in range(nq):
        row, kq = divmod(t, HW // 2)
        f, e = row * HW + 2 * kq, (y0 + row + q) & 1
        for c in range(4):
            want[row * L + 4 * kq + c] = ((e ^ (c & 1)), f + c // 2)
    return want


def _keep_words(nsw, plan, keep):
    """``land``'s ballots as one int: bit 32*(i*WPI + t // 32) + t % 32 set
    where copy i of thread t is of a black cell (half 0) whose keep is not
    0."""
    _, _, wpi, _ = _march_threads(nsw)
    words = 0
    for i, t, _, r, lx, half, _, ok in plan:
        if half == 0 and ok and keep[r, lx] != 0:
            words |= 1 << (32 * (i * wpi + t // 32) + t % 32)
    return words


def _kpos(nsw, t):
    """The kernel's ``kpos`` of quad t: 32 * word + bit of its first cell
    in a slot's keep bits."""
    _, nq, wpi, _ = _march_threads(nsw)
    b = 4 * t // nq
    tl = 4 * t - b * nq
    return (b * wpi + (tl >> 5)) * 32 + (tl & 31)


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("where", ["interior", "low faces", "high faces",
                                   "z ends"])
def test_march_coalesced_loads_land_where_their_owner_reads(nsw, where):
    """The keep forms' plane loads (rbgs_tile.cuh ``fetch``, ``land``):
    every cell of a ring plane lands exactly once, in the colour half and
    word its quad's owner reads it from (a zero outside the domain), a
    warp's 32 copies read consecutive cells and write 32 banks, and where
    a red half reads its black neighbours' keep bits it finds each
    neighbour's own (``half``'s windows from ``kpos``). Interior and face
    blocks, and the first and last planes, each of both parities."""
    M, L, LY, HW, R = march_geometry(nsw)
    tx, ty = MARCH_TILE[nsw]
    threads, nq, wpi, hp = _march_threads(nsw)
    D, H, W = 9, 2 * ty + 7, 3 * tx + 5
    block = {"interior": (tx - M, ty - M), "low faces": (-M, -M),
             "high faces": (3 * tx - M, 2 * ty - M),
             "z ends": (tx - M, -M)}
    x0, y0 = block[where]
    assert face_block(x0, y0, H, W, nsw) == (where != "interior")
    planes = (0, 1, D - 2, D - 1) if where == "z ends" else (3, 4)
    rng = np.random.default_rng(nsw * 10 + len(where))
    for q in planes:
        plan = _load_plan(nsw, x0, y0, q, D, H, W)
        owner = _owner_words(nsw, y0, q)
        assert sorted(c for _, _, c, *_ in plan) == list(range(L * LY))
        assert {c: (half, w) for _, _, c, _, _, half, w, _ in plan} == owner
        for i, t, c, r, lx, _, _, ok in plan:
            assert (r, lx) == (t // L + i * (LY // 4), t % L), (i, t)
            assert ok == (0 <= x0 + lx < W and 0 <= y0 + r < H), (c, q)
        warps = {}
        for row in plan:                     # a warp's copy i
            warps.setdefault((row[0], row[1] // 32), []).append(row)
        assert len(warps) == 4 * -(-nq // 32)
        for warp in warps.values():
            cells = [row[2] for row in warp]
            assert cells == list(range(cells[0], cells[0] + len(cells)))
            banks = [(row[5] * hp + row[6]) % 32 for row in warp]
            assert len(set(banks)) == len(banks), (q, warp[0][:2])
    # the red half's reads of its black neighbours' keep bits on plane q
    # (``half``'s windows from kpos + off): x at -1, +1, +3, rows ±1 at
    # ±(L or L + the copy's spare bits), planes q ± 1 at 0, each the bit of
    # that neighbour, for every red cell a half-sweep updates
    keeps = {q: (rng.uniform(size=(LY, L)) < 0.6).astype(np.float32)
             for q in range(2, 6)}
    words = {q: _keep_words(nsw, _load_plan(nsw, x0, y0, q, D, H, W), k)
             for q, k in keeps.items()}
    pad, rs = 32 * wpi - nq, LY // 4
    for q, t in ((q, t) for q in (3, 4) for t in range(nq)):
        row, kq = divmod(t, HW // 2)
        if not 1 <= row <= LY - 2:
            continue
        off = (1 ^ (y0 + row) ^ q) & 1    # the red half's first cell
        k0 = _kpos(nsw, t) + off
        dyp = L + (pad if row % rs == rs - 1 else 0)
        dym = L + (pad if row % rs == 0 else 0)
        for lx, dx in ((4 * kq + off, 0), (4 * kq + off + 2, 2)):
            if not 1 <= lx <= L - 2:
                continue
            reads = [(q, row, lx - 1, k0 + dx - 1), (q, row, lx + 1,
                                                    k0 + dx + 1),
                     (q, row + 1, lx, k0 + dyp + dx),
                     (q, row - 1, lx, k0 - dym + dx),
                     (q + 1, row, lx, k0 + dx), (q - 1, row, lx, k0 + dx)]
            for qq, r, x, pos in reads:
                assert (x0 + x + y0 + r + qq) & 1 == 0   # a black cell
                inside = 0 <= x0 + x < W and 0 <= y0 + r < H
                want = inside and keeps[qq][r, x] != 0
                assert (words[qq] >> pos) & 1 == want, (t, qq, r, x)


def test_march_coalesced_plan_is_the_kernels():
    """The model's formulas are the kernel's: the copies' rows, half and
    word, the ballot's word, the owner's bits, the halves' 16-word offset,
    and the ring's shared memory, which keeps two keep blocks an SM at nsw
    2."""
    src = (Path(linsolve_stream.__file__).parents[1] / "csrc"
           / "rbgs_tile.cuh").read_text()
    for expr in ("static constexpr int RS = LY / 4;",
                 "static constexpr int WPI = THREADS / 32;",
                 "static constexpr int KW = 4 * WPI + 4;",
                 "const int cy = y0 + t / G::L, cx = x0 + t % G::L;",
                 "cpar = (cx + cy) & 1;",
                 "const int e = (cpar ^ q) & 1;   // the half of copy 0",
                 "const int hf = e ^ (i * G::RS & 1), wi = w + i * (G::NQ / 2);",
                 "kb[s * G::KW + i * G::WPI + (threadIdx.x >> 5)] = bits;",
                 "const int b = 4 * t / G::NQ, tl = 4 * t - b * G::NQ;",
                 "kpos = (b * G::WPI + (tl >> 5)) * 32 + (tl & 31);",
                 "const int dyp = G::L + (row % G::RS == G::RS - 1 ? PAD : 0);",
                 "const int dym = G::L + (row % G::RS == 0 ? PAD : 0);",
                 "const unsigned bx = kwin(s, k0 - 1);",
                 "const unsigned by = kwin(s, k0 + dyp), bm = kwin(s, k0 - dym);",
                 "const unsigned bp = kwin(sp, k0), bz = kwin(sm, k0);",
                 "return March<NSW>::HS + (COAL ? 16 : 0);"):
        assert expr in src, expr
    threads, nq, wpi, hp = _march_threads(2)
    _, L, LY, HW, R = march_geometry(2)
    smem = 4 * (R * 4 * hp + R * (4 * wpi + 4) + hp - 16)
    assert (threads, nq, wpi, smem) == (416, 400, 13, 96160)
    # two blocks an SM in the 196 KB carveout, which leaves 60 KB of L1
    assert 2 * (smem + 1024) <= 196 * 1024


def test_pass_probe_runs_its_rows_on_the_cpu(capsys):
    """tools/exp_pass on the host: every production form of the pass
    kernel, each row its plain version on the host clock."""
    assert exp_pass.main(["--device", "cpu", "--shape", "12", "8", "6",
                          "--n", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host CPU, host clock (no device metric)" in lines[0]
    assert [ln[:18].strip() for ln in lines[1:]] == [
        "sweep1", "pass nsw=1", "pass nsw=1 keep", "pass nsw=2",
        "pass nsw=2 keep"]
    assert all(ln.endswith("(host clock; no bound)") for ln in lines[1:])


def test_pass_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_pass.main(["--n", "1"])
