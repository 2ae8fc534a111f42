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
