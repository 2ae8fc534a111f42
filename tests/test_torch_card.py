"""Tests of the port that need the card (``card`` marker). Each skips, with
a reason, where no CUDA device is visible, and decides so inside the test.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_card.py -q --noconftest
"""

import pytest
import torch

from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls


@pytest.mark.card
@pytest.mark.parametrize("form", ls.MARCH_FORMS)
def test_march_form_fits_two_blocks_an_sm(form):
    """Every form of the pass kernel keeps two blocks on an SM, so that one
    block's barriers and plane loads overlap the other's work: exactly two
    at nsw 2, empty and keep (its shared memory fits no third), at least
    two for sweep 1 and the nsw 1 passes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    blocks = ls.march_blocks_per_sm(*form)
    if form[0] == 2:
        assert blocks == 2, (form, blocks)
    else:
        assert blocks >= 2, (form, blocks)


# (D, H, W) of the keep passes' cases: W and H off the 32-cell tile and W
# % 4 != 0, D under the ring, under a 32-plane z-range and one past it,
# grids of face and interior blocks, and the bench's 512x256x256
PASS_SHAPES = [(1, 7, 13), (3, 21, 37), (33, 13, 9), (11, 36, 70),
               (35, 70, 101), (256, 256, 512)]


def _pass_case(dhw, mask, seed):
    """A carry, an interior rhs view and the keep operand, on the card: an
    interior view of the padded ``keep_vel`` or ``keep_scalar`` (the
    solves') or the contiguous ``fluid_i`` (the masked projection's), of
    random 0/1 solids, or of the bench's sphere at 512x256x256."""
    from fluid_simulation_tpu_torch.scene.masks import build_masks
    from fluid_simulation_tpu_torch.scene.primitives import (
        big_sphere, empty_obstacles)
    D, H, W = dhw
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dhw == (256, 256, 512):
        obs = big_sphere(W, H, D)
    else:
        obs = empty_obstacles(W, H, D)
        solid = torch.rand((D, H, W), generator=g, device="cuda") < 0.2
        obs[1:-1, 1:-1, 1:-1] = solid.float().cpu().numpy()
    m = build_masks(obs, device="cuda")
    keep_i = (m.fluid_i if mask == "fluid_i" else
              getattr(m, mask)[1:-1, 1:-1, 1:-1])
    fpre = torch.randn((D, H, W), generator=g, device="cuda")
    rhs = torch.randn((D + 2, H + 2, W + 2), generator=g, device="cuda")
    return fpre, rhs[1:-1, 1:-1, 1:-1], keep_i


@pytest.mark.card
@pytest.mark.parametrize("dhw", PASS_SHAPES)
@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("mask,b,a,c,wall_mode", [
    ("keep_vel", 1, 0.7, 5.2, "reference"),
    ("keep_scalar", 0, 2.5e-3, 1.015, "noslip"),
    ("fluid_i", 0, 1.0, 6.0, "reference")])
def test_keep_pass_bitwise_to_plain(dhw, nsw, mask, b, a, c, wall_mode):
    """The pass kernel's keep forms (nsw 1 and 2; their coalesced plane
    loads, ``csrc/rbgs_tile.cuh``) equal ``pass_plain`` bit for bit, with
    the keep operand as the step passes it: an interior view of a padded
    keep mask (the diffusions') or the contiguous ``fluid_i`` (the
    projection's Poisson solve, a = 1, c = 6). Each call counts one
    ``rbgs_pass_keep``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    fpre, rhs_i, keep_i = _pass_case(dhw, mask, seed=sum(dhw) + nsw)
    assert keep_i.is_contiguous() == (mask == "fluid_i")
    before = LAUNCHES["rbgs_pass_keep"]
    got = ls.sweep_pass(fpre, rhs_i, keep_i, b, a, c, nsw, wall_mode)
    assert LAUNCHES["rbgs_pass_keep"] == before + 1
    want = ls.pass_plain(fpre, rhs_i, keep_i, b, a, c, nsw, wall_mode)
    assert _same_bits(got, want)


def _halo_obstacles(nsw, axis, side):
    """A padded obstacle field of 4 x 4 x 4 pass blocks at ``nsw`` whose one
    solid cell, a black one, lies in block (1, 1, 1)'s halo and in no other
    part of it: M = 2*nsw cells past its tile along ``axis`` on ``side``
    (its footprint's last cell), inside its tile and z-range along the
    other two. Returns (obstacles, the cell as (z, y, x) of the interior)."""
    from fluid_simulation_tpu_torch.scene.primitives import empty_obstacles
    M, chunk = 2 * nsw, ls.MARCH_CHUNK
    tx, ty = ls.MARCH_TILE[nsw]
    W, H, D = 3 * tx + 5, 3 * ty + 3, 3 * chunk + M + 1
    lo = {"x": tx, "y": ty, "z": chunk}
    span = {"x": tx, "y": ty, "z": chunk}
    cell = {"x": tx + 3, "y": ty + 2, "z": chunk + 1}
    cell[axis] = (lo[axis] - M if side == "low"
                  else lo[axis] + span[axis] + M - 1)
    if (cell["x"] + cell["y"] + cell["z"]) & 1:     # red: one cell over
        cell["x" if axis == "y" else "y"] += 1
    obs = empty_obstacles(W, H, D)
    z, y, x = cell["z"], cell["y"], cell["x"]
    obs[z + 1, y + 1, x + 1] = 1.0
    return obs, (z, y, x)


@pytest.mark.card
@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("axis,side", [("x", "high"), ("y", "high"),
                                       ("z", "high"), ("x", "low"),
                                       ("y", "low"), ("z", "low")])
@pytest.mark.parametrize("mask", ["keep_vel", "fluid_i"])
def test_keep_pass_keep_free_blocks_bitwise_to_plain(nsw, axis, side, mask):
    """The keep pass on a grid of keep-free and flagged blocks (one solid
    only in a block's halo, M cells from its tile in x, y or z): its table
    is ``march_table_plain``'s, with that block flagged and most blocks
    not; the pass equals ``pass_plain`` bit for bit with the padded
    ``keep_vel`` view and the contiguous ``fluid_i``; and ``MARCH_BLOCKS``
    counts the table's flagged blocks as keep-form blocks, the rest as
    keep-free."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES, MARCH_BLOCKS
    from fluid_simulation_tpu_torch.scene.masks import build_masks
    obs, _ = _halo_obstacles(nsw, axis, side)
    m = build_masks(obs, device="cuda")
    keep_i = (m.fluid_i if mask == "fluid_i" else
              m.keep_vel[1:-1, 1:-1, 1:-1])
    D, H, W = keep_i.shape
    g = torch.Generator(device="cuda").manual_seed(D * H + W + nsw)
    fpre = torch.randn((D, H, W), generator=g, device="cuda")
    rhs_i = torch.randn((D + 2, H + 2, W + 2), generator=g,
                        device="cuda")[1:-1, 1:-1, 1:-1]
    table, flagged = ls.march_table(keep_i, nsw)
    flagged = int(flagged)
    plain = ls.march_table_plain(keep_i.cpu(), nsw)
    assert torch.equal(table.cpu(), plain) and flagged == int(plain.sum())
    assert table[1, 1, 1] and 0 < flagged < table.numel() // 4
    before = dict(MARCH_BLOCKS, passes=LAUNCHES["rbgs_pass_keep"])
    got = ls.sweep_pass(fpre, rhs_i, keep_i, 1, 0.7, 5.2, nsw)
    assert LAUNCHES["rbgs_pass_keep"] == before["passes"] + 1
    assert MARCH_BLOCKS["keep_form"] == before["keep_form"] + flagged
    assert MARCH_BLOCKS["keep_free"] == (before["keep_free"] + table.numel()
                                         - flagged)
    want = ls.pass_plain(fpre, rhs_i, keep_i, 1, 0.7, 5.2, nsw)
    assert _same_bits(got, want)


@pytest.mark.card
def test_keep_pass_table_follows_add_obstacle():
    """``WindTunnel.add_obstacle`` between two keep solves builds new
    masks, which may take the old masks' addresses: the second solve reads
    a table of its own mask (the new solid's blocks flagged) and both
    solves equal the plain streamed solve bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch import SimParams, WindTunnel
    obs, _ = _halo_obstacles(2, "x", "high")
    D, H, W = (n - 2 for n in obs.shape)
    wt = WindTunnel(SimParams(width=W, height=H, depth=D, mode="split"),
                    obstacles=obs, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(29)
    f, prev = (torch.randn(obs.shape, generator=g, device="cuda")
               for _ in range(2))
    tables = []
    for cell in (None, (W - 3, H - 2, D - 1)):      # (x, y, z), 1-based
        if cell is not None:
            wt.add_obstacle(*cell)
        keep = wt.masks.keep_vel
        got = ls.rbgs_solve_stream(1, f, prev, 0.7, 5.2, 15, keep=keep)
        want = ls.rbgs_solve_stream_plain(1, f.cpu(), prev.cpu(), 0.7, 5.2,
                                          15, keep=keep.cpu())
        assert _same_bits(got.cpu(), want)
        table = ls.march_table(keep[1:-1, 1:-1, 1:-1], 2)[0].cpu()
        assert torch.equal(
            table, ls.march_table_plain(keep[1:-1, 1:-1, 1:-1].cpu(), 2))
        tables.append(table)
    assert not tables[0][-1, -1, -1] and tables[1][-1, -1, -1]
    assert torch.equal(tables[0][:2], tables[1][:2])   # z-ranges off it


@pytest.mark.card
@pytest.mark.parametrize("dhw", [(1, 1, 1), (3, 5, 7), (5, 3, 130),
                                 (2, 3, 600), (8, 8, 16)])
@pytest.mark.parametrize("bs", [(0,), (2, 3), (1, 2, 3)])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("masked", [False, True])
def test_pad_bounds_bitwise_to_plain(dhw, bs, wall_mode, masked):
    """The padding kernel (K4/K7) equals ``pad_bounds_plain`` bit for bit on
    ragged grids, one launch a call; the masks are interior views of
    padded masks, as the step passes them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    from fluid_simulation_tpu_torch.kernels.bounds import (
        pad_bounds, pad_bounds_plain)
    D, H, W = dhw
    g = torch.Generator().manual_seed(D * 10007 + H * 101 + W + len(bs))
    smp = torch.randn((len(bs), D, H, W), generator=g)
    padded = [(torch.rand((D + 2, H + 2, W + 2), generator=g) < 0.7).float()
              for _ in range(2) if masked]
    interior = (slice(1, -1),) * 3
    want = pad_bounds_plain(smp, bs, wall_mode,
                            *(m[interior] for m in padded))
    name = "pad_bounds_masked" if masked else "pad_bounds"
    before = LAUNCHES[name]
    got = pad_bounds(smp.cuda(), bs, wall_mode,
                     *(m.cuda()[interior] for m in padded))
    assert LAUNCHES[name] == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


# (D, H, W) of K19's cases: one-cell axes, a ragged 37x11x9, x extents
# over several of a lane's chunks, and the 512x256x256 tunnel
K19_SHAPES = [(1, 1, 1), (2, 3, 5), (9, 11, 37), (5, 3, 130), (3, 2, 600),
              (256, 256, 512)]


def _k19_case(dhw, scene, reach, seed):
    """Padded prev/vx/vy/vz/dens on the card, masks and dt. ``reach``
    "clamp": backtraces up to 1.2 grid extents, so they clamp at every
    face; "near": a few cells, as a developed flow. A quarter of the
    velocities are 0, so those backtraces land on exact integers. The
    scene: "empty", random 0/1 solids on small grids, the bench sphere at
    512x256x256."""
    from fluid_simulation_tpu_torch.scene.masks import build_masks
    from fluid_simulation_tpu_torch.scene.primitives import (
        big_sphere, empty_obstacles)
    D, H, W = dhw
    g = torch.Generator(device="cuda").manual_seed(seed)
    pad = (D + 2, H + 2, W + 2)
    vmax = 12.0 if reach == "clamp" else 40.0 / max(dhw)

    def field(scale):
        return (torch.rand(pad, generator=g, device="cuda") * 2 - 1) * scale

    vel = [field(vmax) for _ in range(3)]
    for v in vel:
        v[torch.rand(pad, generator=g, device="cuda") < 0.25] = 0.0
    dens = field(1.0).abs()
    if scene == "empty":
        obs = empty_obstacles(W, H, D)
    elif dhw == (256, 256, 512):
        obs = big_sphere(W, H, D)
    else:
        obs = empty_obstacles(W, H, D)
        solid = torch.rand((D, H, W), generator=g, device="cuda") < 0.2
        obs[1:-1, 1:-1, 1:-1] = solid.float().cpu().numpy()
    return vel, dens, build_masks(obs, device="cuda"), 0.1


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("dhw", K19_SHAPES)
@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("scene", ["empty", "solids"])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("reach", ["clamp", "near"])
def test_advect_compat_bitwise_to_plain(dhw, b, scene, wall_mode, reach):
    """K19 equals the plain call ``ops.advect.advect`` bit for bit (a
    zero's sign too), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    from fluid_simulation_tpu_torch.kernels.advect_compat import (
        advect_compat)
    from fluid_simulation_tpu_torch.ops.advect import advect
    (vx, vy, vz), dens, m, dt = _k19_case(dhw, scene, reach, seed=7 + b)
    prev = dens if b == 0 else (vx, vy, vz)[b - 1] * 0.5
    empty = scene == "empty"
    before = LAUNCHES["advect_compat"]
    got = advect_compat(b, prev, vx, vy, vz, m, dt, wall_mode, empty)
    assert LAUNCHES["advect_compat"] == before + 1
    assert _same_bits(got, advect(b, prev, vx, vy, vz, m, dt, wall_mode,
                                  empty))


@pytest.mark.card
@pytest.mark.parametrize("dhw", [(9, 11, 37), (256, 256, 512)])
@pytest.mark.parametrize("scene", ["empty", "solids"])
def test_advect_compat_chain_bitwise_to_plain(dhw, scene):
    """Three chained velocity advects and the density advect, as a compat
    step makes them (simulation.cpp:125-127), through K19 and through the
    plain call: the four outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels.advect_compat import (
        advect_compat)
    from fluid_simulation_tpu_torch.ops.advect import advect
    (vx, vy, vz), dens, m, dt = _k19_case(dhw, scene, "near", seed=11)
    pv = [v * 0.9 for v in (vx, vy, vz)]
    empty = scene == "empty"
    outs = []
    for fn in (advect_compat, advect):
        x2 = fn(1, pv[0], vx, vy, vz, m, dt, "reference", empty)
        y2 = fn(2, pv[1], x2, vy, vz, m, dt, "reference", empty)
        z2 = fn(3, pv[2], x2, y2, vz, m, dt, "reference", empty)
        outs.append((x2, y2, z2, fn(0, dens, x2, y2, z2, m, dt,
                                    "reference", empty)))
    for a, b in zip(*outs):
        assert _same_bits(a, b)


# (D, H, W) of K20's cases: one-cell axes, a ragged 37x11x9 and x extents
# that are no multiple of 32 or 128 (W 37, 130, 600), the 128x64x64 tunnel
# and the 512x256x256 one
K20_SHAPES = [(1, 1, 1), (9, 11, 37), (5, 3, 130), (3, 2, 600),
              (64, 64, 128), (256, 256, 512)]


@pytest.mark.card
@pytest.mark.parametrize("dhw", K20_SHAPES)
@pytest.mark.parametrize("scene", ["empty", "solids"])
@pytest.mark.parametrize("reach", ["clamp", "near"])
def test_advect_fast_bitwise_to_plain(dhw, scene, reach):
    """K20 equals ``advect_fast_plain`` bit for bit (a zero's sign too),
    one launch a call, the velocities read in place from
    interior views of padded fields as the step passes them; the saves are
    zero in solids, as a run's are (the 128x64x64 sphere: the flagship's)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    from fluid_simulation_tpu_torch.kernels.advect_fast import (
        advect_fast, advect_fast_plain)
    vel, dens, m, dt = _k20_case(dhw, scene, reach)
    saves = [f * m.keep_scalar for f in (vel[0] * 0.9, vel[1] * 0.9, dens)]
    views = [v[1:-1, 1:-1, 1:-1] for v in vel]
    before = LAUNCHES["advect_fast"]
    got = advect_fast(*views, saves, dt)
    assert LAUNCHES["advect_fast"] == before + 1
    assert _same_bits(got, advect_fast_plain(*views, saves, dt))


def _k20_case(dhw, scene, reach):
    """``_k19_case``, with the flagship sphere at 128x64x64."""
    if dhw != (64, 64, 128) or scene == "empty":
        return _k19_case(dhw, scene, reach, seed=20)
    from fluid_simulation_tpu_torch.scene.masks import build_masks
    from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere
    vel, dens, _, dt = _k19_case(dhw, "empty", reach, seed=20)
    return vel, dens, build_masks(flagship_sphere(), device="cuda"), dt


@pytest.mark.card
@pytest.mark.parametrize("dhw", [(1, 1, 1), (3, 5, 7), (9, 11, 37),
                                 (256, 256, 512)])
def test_confinement_bitwise_to_plain(dhw):
    """Vorticity confinement (K10) equals ``confinement_plain`` bit for bit,
    one counted call, on velocities whose ghost faces the no-slip walls
    wrote, with the interior view of ``keep_vel`` as the step passes it:
    random solids on ragged grids, the bench's sphere at 512x256x256."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    from fluid_simulation_tpu_torch.kernels.vorticity import (
        confinement, confinement_plain)
    from fluid_simulation_tpu_torch.ops.bounds import write_faces_
    from fluid_simulation_tpu_torch.scene.masks import build_masks
    from fluid_simulation_tpu_torch.scene.primitives import (
        big_sphere, empty_obstacles)
    D, H, W = dhw
    g = torch.Generator(device="cuda").manual_seed(D * 10007 + H * 101 + W)
    if dhw == (256, 256, 512):
        obs = big_sphere(W, H, D)
    else:
        obs = empty_obstacles(W, H, D)
        solid = torch.rand((D, H, W), generator=g, device="cuda") < 0.2
        obs[1:-1, 1:-1, 1:-1] = solid.float().cpu().numpy()
    keep_i = build_masks(obs, device="cuda").keep_vel[1:-1, 1:-1, 1:-1]
    vel = []
    for b in (1, 2, 3):
        v = 15.0 * torch.randn((D + 2, H + 2, W + 2), generator=g,
                               device="cuda")
        vel.append(write_faces_(v, b, "noslip"))
    want = confinement_plain(*vel, keep_i, 5.0, 0.05)
    before = LAUNCHES["confinement"]
    got = confinement(*vel, keep_i, 5.0, 0.05)
    assert LAUNCHES["confinement"] == before + 1
    for a, b in zip(got, want):
        assert _same_bits(a, b)


# A fresh process on the card: one tunnel built outside any profiler (its
# context span holds the context), then, under ``trace_ctx``, a second
# tunnel's construction and the process's first step, every C entry point
# called in it recorded by name.
_FIRST_STEP = r"""
import json, sys
import torch
from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import _build
from fluid_simulation_tpu_torch.scene.primitives import flagship_sphere
from fluid_simulation_tpu_torch.utils import profiling

launched = []
for fname in ("launch", "call"):
    def record(name, *args, _real=getattr(_build, fname)):
        launched.append(name)
        return _real(name, *args)
    setattr(_build, fname, record)
a = WindTunnel(SimParams(), device="cuda")
with profiling.trace_ctx(sys.argv[1]):
    b = WindTunnel(SimParams(), obstacles=flagship_sphere(), device="cuda")
    b.step()
print(json.dumps({"a": a.setup_s, "b": b.setup_s, "launched": launched,
                  "process": profiling.PROCESS_SETUP}))
"""


@pytest.mark.card
def test_first_step_records_each_entry_once(tmp_path):
    """In a fresh process at 128x64x64 (compat, the flagship sphere): the
    context span holds the context, and a tunnel's masks, once torch has
    loaded its kernels for them, take under a tenth of it (the process's
    first masks also hold those loads, as its first step holds the step's:
    0.19 s of a first 128x64x64 tunnel's masks on an H100); the first step launches each C entry point once under
    ``fst.first_launch``, kept once by name; the library's load and the
    first launches fit in the first step; and the trace shows the set-up
    spans nested as ``utils/profiling.py`` says, on the clock of the
    device's rows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import json
    import pathlib
    import subprocess
    import sys
    trace = tmp_path / "first_step.json"
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _FIRST_STEP, str(trace)],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    a, b, proc = rec["a"], rec["b"], rec["process"]
    assert a["fst.setup.context"] > 0 and "fst.setup.context" in b
    assert b["fst.setup.masks"] < a["fst.setup.context"] / 10, (a, b)
    assert b["fst.setup.context"] < a["fst.setup.context"] / 10, (a, b)
    assert "fst.first_step" in b and "fst.first_step" not in a
    first = proc["fst.first_launch"]
    assert set(first) == set(rec["launched"]) and first
    assert proc["fst.library"] + sum(first.values()) <= b["fst.first_step"]

    events = json.loads(trace.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith("fst."):
            spans.setdefault(e["name"], []).append((e["ts"],
                                                    e["ts"] + e["dur"]))
    kernels = [e["ts"] for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    (setup,), (step1,), (lib,) = (spans["fst.setup"],
                                  spans["fst.first_step"],
                                  spans["fst.library"])
    assert inside(spans["fst.setup.context"][0], setup)
    assert inside(spans["fst.library.build"][0], lib)
    assert inside(spans["fst.library.load"][0], lib)
    assert inside(lib, step1) and inside(spans["fst.step"][0], step1)
    launches = spans["fst.first_launch"]
    assert len(launches) == len(first)
    for span in launches:
        assert inside(span, step1) and not (span[0] < lib[1]
                                            and lib[0] < span[1])
    # the device's rows on the same clock: the step's kernels start inside
    # it, after its first launch began
    assert any(min(launches)[0] <= t <= step1[1] for t in kernels)
