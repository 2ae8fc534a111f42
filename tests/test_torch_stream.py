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
# both walls. (W, H, D), nsw, keep, wall, b, chunk
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
