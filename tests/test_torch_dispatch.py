"""Dispatch guard for the port's CUDA branch, run on the CPU.

The kernel branch of every wrapper only runs on a card, so a fault there
(a wrong argument, a missing import, a wrong count) would pass every plain
CPU test. Here the branch is forced on for CPU tensors and each launcher
is swapped for a stub that checks what the real launcher would be given
(shape, dtype, contiguity, no aliasing of inputs) and writes the plain
result. The production steps then run through the real wrappers: the
empty split and compat steps, obstacle scenes and no-slip walls with
vorticity, compat and fast advection with and without a window (each
``ops.advect.advect`` call one K19 launch, fast's velocity one K20 launch,
with the benchmark's entry points unnested and the spans the card opens),
the step's statistics
(one launch a step, no plain reduction, no host-to-device tensor), and
the launch counters must show which kernels ran, per step. Unported
configurations must raise on the CUDA branch.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, MARCH_BLOCKS, _build, advect_compat as k9, advect_fast as k20,
    advect_split as k3,
    bounds as k4, dma as k23d, hbm as k23h, lerpcost as k24, linsolve as k1,
    linsolve_blocked as k22c,
    linsolve_cpack as k22b, linsolve_mxu as k23m, linsolve_stream as k11,
    linsolve_sweep as k15, prestep as k22a, probe as k23, project as k2,
    project_stream as k14, reset_launches, stats as kst, sweepcost as k23s,
    transpose as k23t, vorticity as k10)
from fluid_simulation_tpu_torch.models import windtunnel as wtm
from fluid_simulation_tpu_torch.models.windtunnel import (
    FluidState, init_state, simulation_step)
from fluid_simulation_tpu_torch.ops import bounds as ops_bounds
from fluid_simulation_tpu_torch.ops.advect import (
    advect, backtrace, gather, trilinear_gather)
from fluid_simulation_tpu_torch.scene.masks import build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    add_sphere, empty_obstacles)
from fluid_simulation_tpu_torch.tools import (
    exp_hbm, exp_hbm2, exp_lerpcost, exp_overhead, exp_sweepcost)

torch.set_num_threads(1)

CPU = "cpu"
W, H, D = 16, 8, 8
# the pass kernel's launcher itself, which counts the keep form's launches
# (the ``card`` fixture swaps it for a stub)
LAUNCH_PASS = k11._launch_pass
PAD = (D + 2, H + 2, W + 2)
INTERIOR = (D, H, W)


def _operand(t, shape):
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert tuple(t.shape) == tuple(shape), (tuple(t.shape), shape)


def _distinct(*ts):
    ptrs = [t.data_ptr() for t in ts]
    assert len(set(ptrs)) == len(ptrs), "launcher operands alias"


def _mask(m, shape):
    """An interior mask as the kernels take it: float32, x stride 1."""
    assert m.dtype == torch.float32 and m.stride(2) == 1
    assert tuple(m.shape) == tuple(shape), (tuple(m.shape), shape)


def stub_k1(out, prev, b, a, c, acc, wall_mode, keep=None):
    _operand(out, prev.shape)
    _operand(prev, out.shape)
    _distinct(out, prev)
    keep_pad = None
    if keep is not None:
        _mask(keep, [n - 2 for n in out.shape])
        keep_pad = F.pad(keep, (1, 1, 1, 1, 1, 1), value=1.0)
    out.copy_(k1.rbgs_solve_plain(b, out, prev, a, c, acc, wall_mode,
                                  keep_pad))


def stub_k1_unpacked(out, prev, b, a, c, acc, wall_mode, keep):
    for t in (out, prev, keep):
        _operand(t, out.shape)
    _distinct(out, prev, keep)
    out.copy_(k1.rbgs_solve_plain(b, out, prev, a, c, acc, wall_mode, keep))


def stub_k5(outs, prevs, bs, a, c, acc, wall_mode, keep=None):
    assert len(outs) == len(prevs) == len(bs) == 3
    for t in (*outs, *prevs):
        _operand(t, outs[0].shape)
    _distinct(*outs, *prevs)
    keep_pad = None
    if keep is not None:
        _mask(keep, [n - 2 for n in outs[0].shape])
        keep_pad = F.pad(keep, (1, 1, 1, 1, 1, 1), value=1.0)
    res = k1.rbgs_solve3_plain(bs, *outs, *prevs, a, c, acc, wall_mode,
                               keep_pad)
    for dst, src in zip(outs, res):
        dst.copy_(src)


def stub_k9(prev, xb, yb, zb, out):
    interior = [n - 2 for n in prev.shape]
    _operand(prev, prev.shape)
    for t in (xb, yb, zb, out):
        _operand(t, interior)
    _distinct(prev, xb, yb, zb, out)
    out.copy_(trilinear_gather(prev, xb, yb, zb))


def stub_k19(prev, u, v, w, fluid_i, keep, out, scales, neg_mask):
    """K19 from its own arguments: the backtrace with the scales it is
    given, the gather, the mask, the faces by the sign mask, the keep."""
    interior = [n - 2 for n in prev.shape]
    for t in (prev, u, v, w, out):
        _operand(t, prev.shape)
    for t in (prev, u, v, w):
        _distinct(t, out)
    assert (fluid_i is None) == (keep is None)
    if fluid_i is not None:
        _operand(fluid_i, interior)
        _operand(keep, prev.shape)
        _distinct(fluid_i, keep, out)
    assert len(scales) == 3
    assert all(type(c) is np.float32 for c in scales), scales
    inner = (slice(1, -1),) * 3
    coords = []
    for axis, (f, c, n) in enumerate(zip((u, v, w), scales,
                                         interior[::-1])):
        shape = [1, 1, 1]
        shape[2 - axis] = n
        at = torch.arange(1, n + 1, dtype=torch.float32).reshape(shape)
        hi = float(np.float32(n) + np.float32(0.5))
        coords.append((at - float(c) * f[inner]).clamp(0.5, hi))
    smp = trilinear_gather(prev, *coords)
    o = torch.zeros_like(prev)
    o[inner] = smp if fluid_i is None else smp * fluid_i
    sx, sy, sz = (-1.0 if neg_mask >> axis & 1 else 1.0 for axis in range(3))
    assert neg_mask < 8
    o[1:-1, 1:-1, 0] = sx * o[1:-1, 1:-1, 1]
    o[1:-1, 1:-1, -1] = o[1:-1, 1:-1, -2]
    o[1:-1, 0, 1:-1] = sy * o[1:-1, 1, 1:-1]
    o[1:-1, -1, 1:-1] = sy * o[1:-1, -2, 1:-1]
    o[0, 1:-1, 1:-1] = sz * o[1, 1:-1, 1:-1]
    o[-1, 1:-1, 1:-1] = sz * o[-2, 1:-1, 1:-1]
    out.copy_(o if keep is None else o * keep)


def stub_k20(prevs, vel, out, scales):
    """K20 from its own arguments: the backtrace through the velocity
    views with the scales it is given, then the gather of each save."""
    interior = [n - 2 for n in prevs[0].shape]
    for t in prevs:
        _operand(t, prevs[0].shape)
    _operand(out, [3] + interior)
    _distinct(*prevs, out)
    strides = ((interior[1] + 2) * (interior[2] + 2), interior[2] + 2, 1)
    for f in vel:
        assert f.dtype == torch.float32 and f.stride() == strides
        assert tuple(f.shape) == tuple(interior)
    assert len(scales) == 3
    assert all(type(c) is np.float32 for c in scales), scales
    coords = []
    for axis, (f, c, n) in enumerate(zip(vel, scales, interior[::-1])):
        shape = [1, 1, 1]
        shape[2 - axis] = n
        at = torch.arange(1, n + 1, dtype=torch.float32).reshape(shape)
        hi = float(np.float32(n) + np.float32(0.5))
        coords.append((at - float(c) * f).clamp(0.5, hi))
    out.copy_(torch.stack([trilinear_gather(s, *coords) for s in prevs]))


def stub_k2(vx, vy, vz, rhs, p, acc, wall_mode):
    for t in (vx, vy, vz, rhs, p):
        _operand(t, vx.shape)
    _distinct(vx, vy, vz, rhs, p)
    assert not p.any(), "p must start at zero, ghosts included"
    res = k2.project_empty_plain(vx, vy, vz, acc, wall_mode)
    for dst, src in zip((vx, vy, vz), res):
        dst.copy_(src)


def stub_k6(vx, vy, vz, rhs, p, fluid_i, keep_vel_i, acc, wall_mode):
    for t in (vx, vy, vz, rhs, p):
        _operand(t, vx.shape)
    _distinct(vx, vy, vz, rhs, p)
    for m in (fluid_i, keep_vel_i):
        _mask(m, [n - 2 for n in vx.shape])
    assert not p.any(), "p must start at zero, ghosts included"
    res = k2.project_masked_plain(vx, vy, vz, fluid_i, keep_vel_i, acc,
                                  wall_mode)
    for dst, src in zip((vx, vy, vz), res):
        dst.copy_(src)


def stub_k3(prev, vx, vy, vz, a, b, out, dt):
    Bn, D2, H2, W2 = prev.shape
    for t, shape in ((prev, prev.shape), (vx, (D2, H2, W2)),
                     (vy, (D2, H2, W2)), (vz, (D2, H2, W2)),
                     (a, (Bn, D2, H2, W2 - 2)), (b, (Bn, D2, H2 - 2, W2 - 2)),
                     (out, (Bn, D2 - 2, H2 - 2, W2 - 2))):
        _operand(t, shape)
    _distinct(prev, a, b, out)
    out.copy_(k3.advect_split_plain(prev, vx, vy, vz, dt))


def stub_k4(smp, out, bs, wall_mode, fluid_i=None, keep_i=None):
    B, Di, Hi, Wi = smp.shape
    assert B == len(bs)
    _operand(smp, smp.shape)
    _operand(out, (B, Di + 2, Hi + 2, Wi + 2))
    _distinct(smp, out)
    assert (fluid_i is None) == (keep_i is None)
    if fluid_i is not None:
        for m in (fluid_i, keep_i):
            _mask(m, (Di, Hi, Wi))
    out.copy_(torch.stack(k4.pad_bounds_plain(smp, bs, wall_mode, fluid_i,
                                              keep_i)))


def stub_k10(vx, vy, vz, keep_vel_i, w, mag, outs, eps, dt):
    interior = [n - 2 for n in vx.shape]
    for t in (vx, vy, vz, mag, *outs):
        _operand(t, vx.shape)
    _operand(w, [3] + interior)
    _mask(keep_vel_i, interior)
    _distinct(vx, vy, vz, w, mag, *outs)
    assert not mag.any(), "|omega| scratch must start with a zero shell"
    for dst, src in zip(outs, k10.confinement_plain(vx, vy, vz, keep_vel_i,
                                                    eps, dt)):
        dst.copy_(src)


def stub_sweep1(field, rhs_i, out, a, c):
    interior = [n - 2 for n in field.shape]
    _operand(field, field.shape)
    _operand(out, interior)
    _mask(rhs_i, interior)
    _distinct(field, out)
    out.copy_(k11.sweep1_plain(field, rhs_i, a, c))


def stub_pass(fin, rhs_i, keep_i, out, b, a, c, nsw, wall_mode):
    for t in (fin, out):
        _operand(t, fin.shape)
    for m in (rhs_i,) if keep_i is None else (rhs_i, keep_i):
        _mask(m, fin.shape)
    assert nsw in k11.KERNEL_NSW
    _distinct(fin, out, rhs_i)
    out.copy_(k11.pass_plain(fin, rhs_i, keep_i, b, a, c, nsw, wall_mode))


def stub_table(keep_i, nsw, table):
    _mask(keep_i, keep_i.shape)
    assert nsw in k11.KERNEL_NSW and table.dtype == torch.uint8
    assert table.is_contiguous() and tuple(table.shape) == tuple(
        reversed(k11.march_grid(tuple(keep_i.shape), nsw)))
    table.copy_(k11.march_table_plain(keep_i, nsw))


def stub_div(vx, vy, vz, fluid_i, rhs):
    for t in (vx, vy, vz):
        _operand(t, vx.shape)
    _operand(rhs, [n - 2 for n in vx.shape])
    if fluid_i is not None:
        _mask(fluid_i, rhs.shape)
    _distinct(vx, vy, vz, rhs)
    rhs.copy_(k2.divergence_plain(vx, vy, vz, fluid_i))


def stub_grad(vx, vy, vz, fpre, fluid_i, out):
    for t in (vx, vy, vz):
        _operand(t, vx.shape)
    _operand(fpre, [n - 2 for n in vx.shape])
    _operand(out, [3] + list(fpre.shape))
    if fluid_i is not None:
        _mask(fluid_i, fpre.shape)
    _distinct(vx, vy, vz, fpre, out)
    out.copy_(k14.gradient_packed_plain(vx, vy, vz, fpre, fluid_i))


def stub_stats(vx, vy, vz, dens, fluid_i, out, divergence_on, density_on):
    for t in (vx, vy, vz, dens):
        _operand(t, vx.shape)
    _operand(out, (2,))
    if fluid_i is not None:
        _mask(fluid_i, [n - 2 for n in vx.shape])
    assert divergence_on or density_on
    _distinct(vx, vy, vz, dens, out)
    # the kernel's divergence is div_packed's (kernels/project.py)
    nan = float("nan")
    out[0] = torch.sum(dens, dtype=torch.float32) if density_on else nan
    out[1] = (k2.divergence_plain(vx, vy, vz, fluid_i).abs().max()
              if divergence_on else nan)


def stub_sweep_packed(ins, rp, kp, outs, f1, b, a, c, wall_mode):
    for t in ins + outs + (f1,):
        assert t.dtype == torch.float32 and t.is_contiguous()
    for m in (rp, kp):
        _mask(m, ins[0].shape)
    _distinct(*ins, *outs, f1)
    for dst, src in zip(outs, k15.rbgs_sweep_packed_plain(
            b, ins[0], rp, kp, *ins[1:], a, c, wall_mode)):
        dst.copy_(src)


def stub_sweep_padded(out, prev, keep, bp_lo, bp_hi, b, a, c, wall_mode):
    for t in (out, prev) + (() if keep is None else (keep,)):
        _operand(t, out.shape)
    _distinct(out, prev, bp_lo, bp_hi)
    out.copy_(k15.rbgs_sweep_plain(b, out, prev, keep, bp_lo, bp_hi, a, c,
                                   wall_mode, apply_keep=keep is not None))


def stub_prestep(vx, vy, vz, outs, rhs, p, fluid_i, keep_vel_i, a, c, acc,
                 wall_mode):
    for t in (vx, vy, vz, *outs, rhs, p):
        _operand(t, vx.shape)
    _distinct(vx, vy, vz, *outs, rhs, p)
    assert (fluid_i is None) == (keep_vel_i is None)
    if fluid_i is not None:
        for m in (fluid_i, keep_vel_i):
            _mask(m, [n - 2 for n in vx.shape])
    for dst, src in zip(outs, k22a.prestep_plain(vx, vy, vz, fluid_i,
                                                 keep_vel_i, a, c, acc,
                                                 wall_mode)):
        dst.copy_(src)


def stub_blocked(out, prev, keep, b, a, c, acc, wall_mode):
    for t in (out, prev) + (() if keep is None else (keep,)):
        _operand(t, out.shape)
    _distinct(out, prev)
    out.copy_(k22c.rbgs_solve_blocked_plain(b, out, prev, keep, a, c, acc,
                                            wall_mode, keep is None))


def stub_cpack(R, B, PR, PB, KB, a32, crec, signs, nsweep):
    for t in (R, B, PR, PB) + (() if KB is None else (KB,)):
        _operand(t, R.shape)
    _distinct(R, B, PR, PB, *(() if KB is None else (KB,)))
    for dst, src in zip((R, B), k22b._sweeps_plain(R, B, PR, PB, KB, a32,
                                                   crec, signs, nsweep)):
        dst.copy_(src)
    return R, B


def stub_probe(x, out):
    _operand(out, x.shape)
    _distinct(x, out)
    out.copy_(k23.add_one_plain(x))


def stub_hbm(a, b, out, blk, hb, halo, chain):
    for t in (a, out) + (() if b is None else (b,)):
        _operand(t, a.shape)
    _distinct(a, out)
    if b is not None:
        _distinct(b, out)
    out.copy_(k23h.stream_copy_plain(a, b, blk=blk, halo=halo, chain=chain,
                                     hb=hb))


def stub_sweepcost(fin, rhs_i, out, variant, nsw, b, a, c, wall_mode):
    for t in (fin, out):
        _operand(t, fin.shape)
    _mask(rhs_i, fin.shape)
    assert variant in k23s.VARIANTS and nsw in k11.KERNEL_NSW
    _distinct(fin, out, rhs_i)
    out.copy_(k23s.sweep_pass_variant_plain(fin, rhs_i, variant, nsw, b, a,
                                            c, wall_mode))


def stub_dma(a, b, out, form, blk, loader, hb):
    for t in (a, b, out):
        assert t.dtype in k23d.DTYPES and t.is_contiguous()
        assert t.shape == a.shape
    _distinct(a, b, out)
    out.copy_(k23d.dma_stream_plain(a, b, form=form, blk=blk, loader=loader,
                                    hb=hb))


def stub_transpose(v, out):
    B, R, C = v.shape
    _operand(out, (B, C, R))
    _distinct(v, out)
    out.copy_(k23t.transpose2d_plain(v))


def stub_strided_copy(x, shape, strides, out, scale):
    v = x.as_strided(shape, strides)
    assert v.ndim == 3 and v.numel() == out.numel()
    _distinct(v, out)
    out.copy_(k23t.strided_copy_plain(v, scale).reshape(out.shape))


def stub_lerp_pass(src, vel, out, axis, dtN, off):
    _operand(src, src.shape)
    _operand(vel, vel.shape)
    _distinct(src, vel, out)
    out.copy_(k3.lerp_pass_plain(src, vel, axis, dtN, off))


def stub_mxu(out, prev, a, c, acc):
    _operand(out, prev.shape)
    _operand(prev, out.shape)
    _distinct(out, prev)
    out.copy_(k23m.rbgs_solve_mxu_plain(out, prev, a, c, acc))


def stub_lerpcost(arr, xb, out, variant):
    _operand(arr, arr.shape)
    _operand(xb, (arr.shape[1], out.shape[2]))
    _operand(out, (arr.shape[0], arr.shape[1], xb.shape[1]))
    assert variant in k24.VARIANTS
    _distinct(arr, xb, out)
    out.copy_(k24.lerpcost_pass_plain(arr, xb, variant))


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; launchers are stubs."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    for mod, name, stub in ((k1, "_launch", stub_k1),
                            (k1, "_launch_unpacked", stub_k1_unpacked),
                            (k1, "_launch3", stub_k5),
                            (k9, "_launch", stub_k9),
                            (k9, "_launch_advect", stub_k19),
                            (k20, "_launch", stub_k20),
                            (k2, "_launch", stub_k2),
                            (k2, "_launch_masked", stub_k6),
                            (k3, "_launch", stub_k3), (k4, "_launch", stub_k4),
                            (k10, "_launch", stub_k10),
                            (k11, "_launch_sweep1", stub_sweep1),
                            (k11, "_launch_pass", stub_pass),
                            (k11, "_launch_table", stub_table),
                            (k14, "_launch_div", stub_div),
                            (k14, "_launch_grad", stub_grad),
                            (k15, "_launch_packed", stub_sweep_packed),
                            (k15, "_launch_padded", stub_sweep_padded),
                            (k22a, "_launch", stub_prestep),
                            (k22c, "_launch", stub_blocked),
                            (k22b, "_launch", stub_cpack),
                            (k23, "_launch", stub_probe),
                            (k23h, "_launch", stub_hbm),
                            (k23s, "_launch", stub_sweepcost),
                            (k23d, "_launch", stub_dma),
                            (k23t, "_launch_transpose", stub_transpose),
                            (k23t, "_launch_copy", stub_strided_copy),
                            (k3, "_launch_pass", stub_lerp_pass),
                            (k23m, "_launch", stub_mxu),
                            (k24, "_launch", stub_lerpcost),
                            (kst, "_launch", stub_stats)):
        monkeypatch.setattr(mod, name, stub)
    reset_launches()
    yield
    reset_launches()


def _counts(**nonzero):
    """LAUNCHES as it should read, from its nonzero entries."""
    return {k: nonzero.get(k, 0) for k in LAUNCHES}


def _step_counts(**nonzero):
    """``_counts`` of one step, which computes its statistics in one
    ``step_stats`` launch (both are on by default)."""
    return _counts(step_stats=1, **nonzero)


def _random_state(p, seed=0):
    rng = np.random.default_rng(seed)
    fields = [rng.uniform(-2, 2, size=p.padded_shape) for _ in range(3)]
    fields[0] += 20
    fields.append(rng.uniform(0, 0.01, size=p.padded_shape))
    return [torch.tensor(f, dtype=torch.float32) for f in fields]


def _run_two_steps(p, obstacles=None, zero_edges=False):
    """Two steps through the stubbed kernel branch from a random state;
    the per-step launch counts, after checking that the kernel branch
    computes what the plain step computes. ``zero_edges`` zeroes the ghost
    edges and corners, as every state of a run has them: the streamed
    projection's pad_bounds tail writes them 0 where the resident one and
    the plain step pass them through."""
    wt = WindTunnel(p, obstacles=obstacles, device=CPU)
    state = _random_state(p)
    if zero_edges:
        shell = torch.zeros(p.padded_shape)
        shell[1:-1, 1:-1, :] = shell[1:-1, :, 1:-1] = 1.0
        shell[:, 1:-1, 1:-1] = 1.0
        state = [f * shell for f in state]
    wt.state = FluidState(*state)
    start = wt.state
    wt.simulate(2)
    per_step = {k: n / 2 for k, n in LAUNCHES.items()}
    ref = start
    for _ in range(2):
        ref, _ = simulation_step(ref, wt.masks, wt.params.replace(
            use_pallas=False))
    for a, b in zip(wt.state, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    return per_step


@pytest.mark.parametrize("mode,counts", [
    ("split", (3, 2, 2, 2, 0, 0)), ("compat", (3, 2, 0, 0, 4, 0)),
    ("fast", (3, 2, 0, 1, 1, 1))])
def test_production_step_launch_counts(card, mode, counts):
    """Each advect call on the card is one K19 launch: compat's four,
    fast's density; fast's velocity samples are one K20 launch."""
    p = SimParams(width=W, height=H, depth=D, acc=4, mode=mode)
    per_step = _run_two_steps(p)
    assert per_step == _step_counts(**dict(zip(
        ("rbgs_solve", "project_empty", "advect_split", "pad_bounds",
         "advect_compat", "advect_fast"), counts)))


SPHERE = "sphere"


@pytest.mark.parametrize("mode,scene,change,nonzero", [
    ("split", SPHERE, {}, dict(rbgs_solve_keep=3, project_masked=2,
                               advect_split=2, pad_bounds_masked=2)),
    ("compat", SPHERE, {}, dict(rbgs_solve_keep=3, project_masked=2,
                                advect_compat=4)),
    ("fast", SPHERE, {}, dict(rbgs_solve_keep=3, project_masked=2,
                              pad_bounds_masked=1, advect_compat=1,
                              advect_fast=1)),
    ("split", None, dict(wall_mode="noslip", vorticity=5.0),
     dict(rbgs_solve=3, project_empty=2, advect_split=2, pad_bounds=2,
          confinement=1)),
    ("split", SPHERE, dict(wall_mode="noslip", vorticity=5.0),
     dict(rbgs_solve_keep=3, project_masked=2, advect_split=2,
          pad_bounds_masked=2, confinement=1)),
    ("compat", None, dict(wall_mode="noslip", vorticity=5.0),
     dict(rbgs_solve=3, project_empty=2, confinement=1, advect_compat=4)),
])
def test_obstacle_and_vorticity_step_launch_counts(card, mode, scene, change,
                                                   nonzero):
    """Obstacle scenes and no-slip walls with vorticity run their kernels:
    a keep solve counts as rbgs_solve_keep, never as rbgs_solve."""
    p = SimParams(width=W, height=H, depth=D, acc=4, mode=mode, **change)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    assert _run_two_steps(p, obs) == _step_counts(**nonzero)


# the JAX bench's big configs (bench.py:227-263): interior (W, H, D)
BIG_GRIDS = [(256, 128, 128), (256, 256, 256), (512, 256, 256)]


def test_stream_route_by_shape():
    """The route constant alone: the 128x64x64 class stays resident, each of
    the bench's big grids (empty and sphere alike) streams."""
    def padded(w, h, d):
        return (d + 2, h + 2, w + 2)

    assert not k11.streams(padded(128, 64, 64))
    assert not k11.streams(padded(16, 8, 8))
    for dims in BIG_GRIDS:
        assert k11.streams(padded(*dims)), dims
    assert k11.NSW in k11.KERNEL_NSW


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("scene,change", [
    (None, {}), (SPHERE, {}), (None, dict(wall_mode="noslip", vorticity=5.0))])
def test_streamed_step_launch_counts(card, monkeypatch, streamed, scene,
                                     change):
    """With the route constant lowered to 16x8x8, the production split step
    streams its 3 solves and 2 projections and pads 4 stacks (the
    projections' tails); as shipped, the same step keeps the resident
    counts. Both equal the plain step (``_run_two_steps``)."""
    if streamed:
        monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    p = SimParams(width=W, height=H, depth=D, acc=5, mode="split", **change)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    vort = dict(confinement=1) if change else {}
    if streamed and scene:
        want = dict(rbgs_solve_stream_keep=3, project_stream_masked=2,
                    advect_split=2, pad_bounds_masked=4)
    elif streamed:
        want = dict(rbgs_solve_stream=3, project_stream=2, advect_split=2,
                    pad_bounds=4)
    elif scene:
        want = dict(rbgs_solve_keep=3, project_masked=2, advect_split=2,
                    pad_bounds_masked=2)
    else:
        want = dict(rbgs_solve=3, project_empty=2, advect_split=2,
                    pad_bounds=2)
    assert _run_two_steps(p, obs, zero_edges=True) == _step_counts(
        **want, **vort)


@pytest.mark.parametrize("scene,keep_passes", [(SPHERE, 37), (None, 0)])
def test_streamed_step_counts_its_keep_passes(card, monkeypatch, scene,
                                              keep_passes):
    """``rbgs_pass_keep`` counts the pass kernel's launches with a keep
    mask (``linsolve_stream._launch_pass``, the launch itself stubbed): a
    512x256x256 sphere step's routing (acc 15, the route constant lowered
    to this grid) launches 37 passes, three diffusions of seven after sweep
    1 and two projections of seven and a one-sweep remainder, and every one
    is the keep form, each with its mask's table (one block here, which
    the sphere flags, so ``MARCH_BLOCKS`` counts 37 keep-form blocks); an
    empty step launches the same 37 and counts none."""
    assert k11.streams((258, 258, 514)) and SimParams().acc == 15
    monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    monkeypatch.setattr(k11, "_launch_pass", LAUNCH_PASS)
    passes = []

    def launch(name, device, *args):
        assert name == "fst_rbgs_pass" and device == -1
        assert (args[4] is None) == (args[15] is None)   # keep, its table
        passes.append((args[4] is not None, args[13]))   # keep, nsw
    monkeypatch.setattr(_build, "launch", launch)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    WindTunnel(SimParams(width=W, height=H, depth=D, mode="split"),
               obstacles=obs, device=CPU).simulate(1)
    assert sorted(passes) == [(scene is not None, 1)] * 2 + [
        (scene is not None, 2)] * 35
    assert LAUNCHES["rbgs_pass_keep"] == keep_passes
    assert MARCH_BLOCKS == {"keep_form": keep_passes, "keep_free": 0}
    assert LAUNCHES[("rbgs_solve_stream_keep" if scene else
                     "rbgs_solve_stream")] == 3


@pytest.mark.parametrize("inference", [False, True])
def test_streamed_steps_build_each_table_once(card, monkeypatch, inference):
    """A streamed sphere tunnel's keep passes read three tables
    (``keep_vel`` at nsw 2, ``fluid_i`` at nsw 2 and 1), built in its first
    step and kept: the second step builds none, also where the tunnel is
    built and stepped under ``torch.inference_mode``, since its masks are
    no inference tensors. ``MARCH_BLOCKS`` counts both steps' 74 keep
    passes (the launch itself stubbed), each of one block, which the
    sphere flags."""
    monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    monkeypatch.setattr(k11, "_launch_pass", LAUNCH_PASS)
    monkeypatch.setattr(_build, "launch", lambda *args: None)
    built = []

    def table(keep_i, nsw, out):
        built.append(nsw)
        stub_table(keep_i, nsw, out)
    monkeypatch.setattr(k11, "_launch_table", table)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2)
    with torch.inference_mode(inference):
        wt = WindTunnel(SimParams(width=W, height=H, depth=D, mode="split"),
                        obstacles=obs, device=CPU)
        wt.simulate(1)
        first = sorted(built)
        wt.simulate(1)
    assert first == sorted(built) == [1, 2, 2]
    assert wt.masks.keep_vel.is_inference() is False
    assert LAUNCHES["rbgs_pass_keep"] == 74
    assert MARCH_BLOCKS == {"keep_form": 74, "keep_free": 0}


@pytest.mark.parametrize("scene", [None, SPHERE])
def test_streamed_compat_step_samples_plain(card, monkeypatch, scene):
    """The default mode on a streamed-route grid (the route constant
    lowered to 16x8x8): compat streams its 3 solves and 2 projections,
    pads only the projections' two stacks, and runs each of its four
    advects whole in K19 at window 0, never the trilinear kernel; the
    plain reference samples through the plain gather. ``advect`` takes
    all its arguments by position, as wrappers of it pass them. Equal to
    the plain step (``_run_two_steps``)."""
    monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    calls = []
    advect = wtm.advect

    def recording(*args):
        calls.append((len(args), args[-1]))
        return advect(*args)
    monkeypatch.setattr(wtm, "advect", recording)
    p = SimParams(width=W, height=H, depth=D, acc=5)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    want = (dict(rbgs_solve_stream_keep=3, project_stream_masked=2,
                 pad_bounds_masked=2) if scene else
            dict(rbgs_solve_stream=3, project_stream=2, pad_bounds=2))
    assert _run_two_steps(p, obs, zero_edges=True) == _step_counts(
        advect_compat=4, **want)
    # two steps of the kernel branch, then two of the plain reference
    assert calls == [(10, k9.advect_compat)] * 8 + [(10, None)] * 8


def test_plain_reference_run_launches_nothing(card):
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="split",
                  use_pallas=False, wall_mode="noslip", vorticity=5.0)
    WindTunnel(p, device=CPU).simulate(1)
    WindTunnel(p, obstacles=add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2),
               device=CPU).simulate(1)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("change", [dict(dtype="bfloat16"),
                                    dict(batched=True)])
def test_unported_config_raises_on_card(card, change):
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="split",
                  **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WindTunnel(p, device=CPU)
    # simulation_step itself refuses too, not only the constructor
    p = p.replace(empty_scene=True)
    masks = build_masks(empty_obstacles(W, H, D), device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        simulation_step(init_state(p, device=CPU), masks, p)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mode,scene,nonzero", [
    ("compat", None, dict(rbgs_solve=3, project_empty=2, advect_compat=4)),
    ("compat", SPHERE, dict(rbgs_solve_keep=3, project_masked=2,
                            advect_compat=4)),
    ("fast", None, dict(rbgs_solve=3, project_empty=2, pad_bounds=1,
                        advect_compat=1, advect_fast=1)),
    ("fast", SPHERE, dict(rbgs_solve_keep=3, project_masked=2,
                          pad_bounds_masked=1, advect_compat=1,
                          advect_fast=1)),
    ("split", None, dict(rbgs_solve=3, project_empty=2, advect_split=2,
                         pad_bounds=2)),
    ("split", SPHERE, dict(rbgs_solve_keep=3, project_masked=2,
                           advect_split=2, pad_bounds_masked=2)),
])
def test_window_step_launch_counts(card, mode, scene, nonzero):
    """advect_window > 0 runs on the card: fast's shared backtrace and
    three velocity samples are one K20 launch, and every advect call,
    compat's four and fast's density, one K19 launch, whatever the window;
    the trilinear kernel has no route; split ignores the window and keeps
    its counts. Each equals the plain step."""
    p = SimParams(width=W, height=H, depth=D, acc=4, mode=mode,
                  advect_window=1)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    assert _run_two_steps(p, obs) == _step_counts(**nonzero)


@pytest.mark.parametrize("mode", ["compat", "fast"])
@pytest.mark.parametrize("window", [0, 1])
def test_plain_gathers_are_counted(card, mode, window):
    """No sample of the step launches the trilinear kernel at either
    window: fast's three velocity samples are one K20 launch a step, and
    each advect call (compat 4 a step, fast 1) one K19 launch. All equal
    the plain step (``_run_two_steps``)."""
    p = SimParams(width=W, height=H, depth=D, acc=3, mode=mode,
                  advect_window=window)
    _run_two_steps(p, add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2))
    assert LAUNCHES["trilinear_gather"] == 0
    assert LAUNCHES["advect_fast"] == (2 if mode == "fast" else 0)
    assert LAUNCHES["advect_compat"] == (8 if mode == "compat" else 2)


@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("scene", [None, SPHERE])
def test_card_fast_step_is_one_k20_and_one_k19_launch(card, window, scene):
    """A fast step on the card samples its velocity in one K20 launch and
    advects its density in one K19 launch, at window 0 and 2, never
    through the trilinear kernel; equal to the plain step."""
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="fast",
                  advect_window=window)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    per_step = _run_two_steps(p, obs)
    assert per_step["advect_fast"] == per_step["advect_compat"] == 1
    assert per_step["trilinear_gather"] == 0


@pytest.mark.parametrize("mode", ["compat", "fast"])
def test_plain_window_run_launches_nothing(card, mode):
    """With use_pallas=False a window changes nothing: plain torch."""
    p = SimParams(width=W, height=H, depth=D, acc=3, mode=mode,
                  use_pallas=False, advect_window=2)
    WindTunnel(p, device=CPU).simulate(1)
    assert set(LAUNCHES.values()) == {0}


def _wild_state(p, seed):
    """Padded fields whose backtraces clamp at every face (velocities up to
    30 cells' worth a step) and land on exact integers (zero velocity on a
    third of the cells)."""
    rng = np.random.default_rng(seed)
    still = rng.uniform(size=p.padded_shape) < 1 / 3
    vel = [np.where(still, 0.0, rng.uniform(-30, 30, size=p.padded_shape))
           for _ in range(3)]
    dens = rng.uniform(0, 1, size=p.padded_shape)
    return [torch.tensor(f, dtype=torch.float32) for f in vel + [dens]]


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("scene", [None, SPHERE])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
def test_advect_compat_launcher_arguments(card, monkeypatch, b, scene,
                                          wall_mode):
    """K19's launcher gets the backtrace's float32 scales, component ``b``
    from ``prev`` and the others from the current fields, ``fluid_i`` and
    the keep mask of ``b`` (none in an empty scene) and the face signs of
    ``b``; the call equals ``ops.advect.advect``'s plain composition bit
    for bit, clamped and integer backtraces included."""
    p = SimParams(width=W, height=H, depth=D, dt=0.1)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    m = build_masks(obs if scene else empty_obstacles(W, H, D), device=CPU)
    vx, vy, vz, dens = _wild_state(p, seed=b)
    prev = dens if b == 0 else (vx, vy, vz)[b - 1].clone()
    empty = scene is None
    seen = []

    def launch(*args):
        seen.append(args)
        stub_k19(*args)
    monkeypatch.setattr(k9, "_launch_advect", launch)
    got = k9.advect_compat(b, prev, vx, vy, vz, m, p.dt, wall_mode, empty)
    want = advect(b, prev, vx, vy, vz, m, p.dt, wall_mode, empty)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert LAUNCHES["advect_compat"] == 1 and len(seen) == 1
    a_prev, u, v, w, fluid_i, keep, out, scales, neg = seen[0]
    assert a_prev is prev and out is got
    assert [t is prev for t in (u, v, w)] == [b == axis for axis in (1, 2, 3)]
    assert [t is f for t, f in zip((u, v, w), (vx, vy, vz))] == [
        b != axis for axis in (1, 2, 3)]
    dt = np.float32(p.dt)
    assert scales == (dt * np.float32(W), dt * np.float32(H),
                      dt * np.float32(D))
    if empty:
        assert fluid_i is None and keep is None
    else:
        assert fluid_i is m.fluid_i
        assert keep is (m.keep_vel if b else m.keep_scalar)
    signs = ops_bounds.face_signs(b, wall_mode)
    assert neg == sum(1 << axis for axis in range(3) if signs[axis] < 0)


def test_advect_compat_refuses_bad_operands(card):
    m = build_masks(empty_obstacles(W, H, D), device=CPU)
    f = torch.zeros(PAD)
    with pytest.raises(NotImplementedError, match="A11"):
        k9.advect_compat(0, f.bfloat16(), f, f, f, m, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        k9.advect_compat(0, f, f, f, torch.zeros(PAD[::-1]).transpose(0, 2),
                         m, 0.05)
    with pytest.raises(ValueError, match="shape"):
        k9.advect_compat(1, f, f, torch.zeros((D, H, W)), f, m, 0.05)
    with pytest.raises(ValueError, match="b must be"):
        k9.advect_compat(4, f, f, f, f, m, 0.05)
    with pytest.raises(ValueError, match="wall_mode"):
        k9.advect_compat(0, f, f, f, f, m, 0.05, "slip")
    small = build_masks(empty_obstacles(W, H, D - 2), device=CPU)
    with pytest.raises(ValueError, match="shape"):
        k9.advect_compat(0, f, f, f, f, small, 0.05)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("dims", [(W, H, D), (37, 11, 9), (5, 1, 2)])
def test_advect_fast_launcher_arguments(card, monkeypatch, dims):
    """K20's launcher gets the three saves and the three velocity views
    themselves (read in place, no copy) and the backtrace's float32
    scales; the call equals ``advect_fast_plain`` bit for bit, clamped and
    integer backtraces included."""
    w, h, d = dims
    p = SimParams(width=w, height=h, depth=d, dt=0.1)
    vel = _wild_state(p, seed=w)[:3]
    saves = [f * 0.5 for f in vel]
    views = [f[1:-1, 1:-1, 1:-1] for f in vel]
    seen = []

    def launch(*args):
        seen.append(args)
        stub_k20(*args)
    monkeypatch.setattr(k20, "_launch", launch)
    got = k20.advect_fast(*views, saves, p.dt)
    want = k20.advect_fast_plain(*views, saves, p.dt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert LAUNCHES["advect_fast"] == 1 and len(seen) == 1
    a_saves, a_vel, out, scales = seen[0]
    assert [a is b for a, b in zip(a_saves, saves)] == [True] * 3
    assert [a is b for a, b in zip(a_vel, views)] == [True] * 3
    assert out is got
    dt = np.float32(p.dt)
    assert scales == (dt * np.float32(w), dt * np.float32(h),
                      dt * np.float32(d))


def test_advect_fast_refuses_bad_operands(card):
    """K20 raises on a save of the wrong shape, dtype or layout, on
    velocities that are not interior views of padded fields (a contiguous
    interior has other strides) and on a wrong count of saves; nothing
    launches."""
    f = torch.zeros(PAD)
    views = [torch.zeros(PAD)[1:-1, 1:-1, 1:-1] for _ in range(3)]
    saves = [f, f.clone(), f.clone()]
    with pytest.raises(NotImplementedError, match="A11"):
        k20.advect_fast(*views, [s.bfloat16() for s in saves], 0.05)
    with pytest.raises(NotImplementedError, match="A11"):
        k20.advect_fast(*views[:2], views[2].bfloat16(), saves, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        k20.advect_fast(*views, saves[:2] + [
            torch.zeros(PAD[::-1]).transpose(0, 2)], 0.05)
    with pytest.raises(ValueError, match="shape"):
        k20.advect_fast(*views, saves[:2] + [torch.zeros((D, H, W))], 0.05)
    with pytest.raises(ValueError, match="strides"):
        k20.advect_fast(*views[:2], views[2].contiguous(), saves, 0.05)
    with pytest.raises(ValueError, match="strides"):
        k20.advect_fast(*views[:2], torch.zeros((D + 2, H + 2, W + 3))[
            1:-1, 1:-1, 1:-2], saves, 0.05)
    with pytest.raises(ValueError, match="3"):
        k20.advect_fast(*views, saves[:2], 0.05)
    with pytest.raises(ValueError, match="go together"):
        backtrace(*views, 0.05, W, H, D, torch.float32, prevs=saves)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("mode", ["compat", "fast"])
def test_card_step_advect_entry_points_do_not_nest(card, monkeypatch,
                                                   streamed, mode):
    """The benchmark's entry points wrapped as a traced run wraps them
    (``windbench.harness.entry_spans``): a compat step on the card records
    four ``ops.advect:advect`` calls with the bytes the roofline counts,
    fast one (density's), and no ``pad_bounds`` call inside any of them
    (an entry's calls are recorded as they end, so a nested one would come
    first). Streamed, the projections' two tails are the only padding."""
    from windbench import harness
    from windbench.metrics import compat_advect_roofline as car
    from windbench.metrics import pad_bounds_roofline as pbr
    if streamed:
        monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    p = SimParams(width=W, height=H, depth=D, acc=3, mode=mode)
    wt = WindTunnel(p, obstacles=add_sphere(empty_obstacles(W, H, D), 5, 4,
                                            4, 2), device=CPU)
    wt.state = FluidState(*_random_state(p))
    readers = {"compat_advect_roofline": car, "pad_bounds_roofline": pbr}
    with harness.entry_spans(readers) as calls:
        wt.step()
    assert wtm.advect is advect and wtm.pad_bounds is k4.pad_bounds
    adv = [("compat_advect_roofline", car.bytes_moved(D, H, W, b > 0, True))
           for b in (1, 2, 3, 0)]
    pad = [("pad_bounds_roofline", pbr.bytes_moved(D, H, W, 3, True))]
    if mode == "fast":
        tail = [("pad_bounds_roofline", pbr.bytes_moved(D, H, W, 3, True))]
        adv = tail + adv[3:]
    want = (pad + adv[:-1] + pad + adv[-1:] if streamed else adv)
    assert calls == want
    assert LAUNCHES["advect_compat"] == (4 if mode == "compat" else 1)


@pytest.mark.parametrize("streamed", [False, True])
def test_card_fast_samples_are_one_backtrace_and_three_gathers(
        card, monkeypatch, streamed):
    """``fast_advect_roofline``'s entry points wrapped as a traced run
    wraps them: a fast step on the card records one ``backtrace`` call,
    its shared backtrace and three velocity samples in one K20 launch,
    with the backtrace's bytes, and no ``gather`` call; density's advect
    is one K19 launch, which calls neither."""
    from windbench import harness
    from windbench.metrics import fast_advect_roofline as far
    if streamed:
        monkeypatch.setattr(k11, "STREAM_MIN_CELLS", W * H * D)
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="fast")
    wt = WindTunnel(p, obstacles=add_sphere(empty_obstacles(W, H, D), 5, 4,
                                            4, 2), device=CPU)
    wt.state = FluidState(*_random_state(p))
    with harness.entry_spans({"fast_advect_roofline": far}) as calls:
        wt.step()
    assert wtm.backtrace is backtrace and wtm.gather is gather
    name = "fast_advect_roofline"
    assert calls == [(name, far.backtrace_bytes(D, H, W))]
    assert LAUNCHES["advect_compat"] == LAUNCHES["advect_fast"] == 1


@pytest.mark.parametrize("mode", ["compat", "fast"])
def test_card_advect_spans(card, mode):
    """On the card each advect call runs whole in ``fst.gather`` and
    opens no span inside it: compat opens no ``fst.backtrace`` and no
    ``fst.bounds`` (the resident projections pad nothing); fast its shared
    velocity backtrace, with K20's launch in ``fst.gather`` inside it, and
    its padding only: two ``fst.gather`` a step."""
    from torch.profiler import ProfilerActivity, profile
    p = SimParams(width=W, height=H, depth=D, acc=3, mode=mode)
    wt = WindTunnel(p, obstacles=add_sphere(empty_obstacles(W, H, D), 5, 4,
                                            4, 2), device=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wt.step()
    events = [e for e in prof.events() if e.name.startswith("fst.")]
    gathers = sorted(e.cpu_parent.name for e in events
                     if e.name == "fst.gather")
    assert gathers == (["fst.advect"] * 3 + ["fst.advect_density"]
                       if mode == "compat" else
                       ["fst.advect_density", "fst.backtrace"])
    assert not [e for e in events if e.cpu_parent is not None
                and e.cpu_parent.name == "fst.gather"]
    for name in ("fst.backtrace", "fst.bounds"):
        parents = [e.cpu_parent.name for e in events if e.name == name]
        assert parents == ([] if mode == "compat" else ["fst.advect"])


def _refuse_plain_stats(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain statistics ran on the card's branch")
    monkeypatch.setattr(kst, "step_stats_plain", refuse)
    monkeypatch.setattr(wtm, "step_stats_plain", refuse)


@pytest.mark.parametrize("mode", ["split", "compat"])
@pytest.mark.parametrize("scene", [None, SPHERE])
def test_step_stats_are_one_launch(card, monkeypatch, mode, scene):
    """A card step computes its statistics in one ``step_stats`` launch and
    never in the plain reductions: the empty scene takes the kernel's
    in-bounds form (no ``fluid_i``), an obstacle scene the masked one. The
    statistics equal the plain step's."""
    p = SimParams(width=W, height=H, depth=D, acc=3, mode=mode)
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2) if scene else None
    wt = WindTunnel(p, obstacles=obs, device=CPU)
    wt.state = start = FluidState(*_random_state(p))
    plain_p = wt.params.replace(use_pallas=False)
    _, want = simulation_step(start, wt.masks, plain_p)
    seen = []

    def launch(vx, vy, vz, dens, fluid_i, out, *flags):
        seen.append(fluid_i)
        stub_stats(vx, vy, vz, dens, fluid_i, out, *flags)

    monkeypatch.setattr(kst, "_launch", launch)
    _refuse_plain_stats(monkeypatch)
    got = wt.step()
    assert LAUNCHES["step_stats"] == 1
    assert (seen[0] is None) == (scene is None) and len(seen) == 1
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == ()
        assert torch.equal(a, b)


@pytest.mark.parametrize("div_stats,step_stats", [
    (True, True), (True, False), (False, True), (False, False)])
def test_step_stats_make_no_host_to_device_tensor(card, monkeypatch,
                                                  div_stats, step_stats):
    """Inside ``fst.stats`` no tensor is made from host data on the device
    (a copy from pageable memory would sync the stream): a statistic that
    is off is a NaN from a device fill, and with both off no kernel runs."""
    inside = []
    real_span, real_tensor = wtm.span, torch.tensor

    def span(name):
        if name != "fst.stats":
            return real_span(name)
        return _flagged(inside, real_span(name))

    def tensor(*args, **kwargs):
        if inside and kwargs.get("device") is not None:
            raise AssertionError("a host-to-device tensor in fst.stats")
        return real_tensor(*args, **kwargs)

    monkeypatch.setattr(wtm, "span", span)
    monkeypatch.setattr(torch, "tensor", tensor)
    p = SimParams(width=W, height=H, depth=D, acc=3, mode="split",
                  div_stats=div_stats, step_stats=step_stats)
    wt = WindTunnel(p, obstacles=add_sphere(empty_obstacles(W, H, D), 5, 4,
                                            4, 2), device=CPU)
    wt.state = FluidState(*_random_state(p))
    _refuse_plain_stats(monkeypatch)
    got = wt.step()
    assert not inside
    assert LAUNCHES["step_stats"] == int(div_stats or step_stats)
    for on, stat in ((step_stats, got.density_sum),
                     (div_stats, got.max_divergence)):
        assert bool(torch.isfinite(stat)) == on


class _flagged:
    """A context manager that marks ``flag`` while ``inner`` is open."""

    def __init__(self, flag, inner):
        self.flag, self.inner = flag, inner

    def __enter__(self):
        self.flag.append(True)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self.flag.pop()
        return self.inner.__exit__(*exc)


def test_variant_wrappers_refuse_bad_operands(card):
    f = torch.zeros(PAD)
    ones_i = torch.ones(INTERIOR)
    bf = torch.zeros(PAD, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A11"):
        k9.trilinear_gather_window(bf, ones_i, ones_i, ones_i)
    with pytest.raises(ValueError, match="shape"):
        k9.trilinear_gather_window(f, ones_i, ones_i, f)
    with pytest.raises(ValueError, match="contiguous"):
        k9.trilinear_gather_window(f, ones_i, ones_i,
                                   torch.ones((W, H, D)).transpose(0, 2))
    with pytest.raises(NotImplementedError, match="A11"):
        k1.rbgs_solve3((1, 2, 3), bf, bf, bf, bf, bf, bf, 0.5, 4.0)
    with pytest.raises(ValueError, match="three"):
        k1.rbgs_solve3((1, 2), f, f, f, f, f, f, 0.5, 4.0)
    with pytest.raises(ValueError, match="x stride"):
        k1.rbgs_solve3((1, 2, 3), f, f, f, f, f, f, 0.5, 4.0,
                       keep=torch.ones((W + 2, H + 2, D + 2)).transpose(0, 2))
    with pytest.raises(ValueError, match="shape"):
        k1.rbgs_solve(1, f, f.clone(), 0.5, 4.0, keep=ones_i, packed=False)
    with pytest.raises(ValueError, match="shape"):
        k3.advect_split_fused(torch.zeros((3,) + PAD), f, f,
                              torch.zeros((4, 4, 4)), 0.05)
    assert set(LAUNCHES.values()) == {0}


def test_wrappers_refuse_unported_operands(card):
    f = torch.zeros(PAD)
    ones_i = torch.ones(INTERIOR)
    bf = torch.zeros(PAD, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A11"):
        k2.project_empty(bf, bf.clone(), bf.clone())
    with pytest.raises(NotImplementedError, match="A11"):
        k2.project_masked(f, f.clone(), f.clone(), ones_i,
                          ones_i.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        k1.rbgs_solve(0, f.transpose(0, 2), f.transpose(0, 2).clone(), 1.0,
                      6.0)
    with pytest.raises(ValueError, match="shape"):
        k1.rbgs_solve(1, f, f.clone(), 0.5, 4.0, keep=ones_i)
    with pytest.raises(ValueError, match="shape"):
        k3.advect_split(torch.zeros((3,) + PAD), f, f, torch.zeros((4, 4, 4)),
                        0.05)
    smp = torch.zeros((1,) + INTERIOR)
    with pytest.raises(ValueError, match="both"):
        k4.pad_bounds(smp, (0,), fluid_i=ones_i)
    with pytest.raises(ValueError, match="x stride"):
        k4.pad_bounds(smp, (0,), fluid_i=ones_i,
                      keep_i=torch.ones((W, H, D)).transpose(0, 2))
    with pytest.raises(ValueError, match="expected"):
        k10.confinement(f, f.clone(), f.clone(), torch.ones(PAD), 5.0, 0.05)
    # the streamed wrappers
    with pytest.raises(NotImplementedError, match="A11"):
        k11.rbgs_solve_stream(0, bf, bf.clone(), 1.0, 6.0)
    with pytest.raises(ValueError, match="contiguous"):
        k11.rbgs_solve_stream(0, f.transpose(0, 2), f.transpose(0, 2).clone(),
                              1.0, 6.0)
    with pytest.raises(ValueError, match="shape"):
        k11.rbgs_solve_stream(1, f, f.clone(), 0.5, 4.0, keep=ones_i)
    with pytest.raises(ValueError, match="nsw"):
        k11.rbgs_solve_stream(1, f, f.clone(), 0.5, 4.0, nsw=3)
    with pytest.raises(NotImplementedError, match="A11"):
        k14.project_stream(bf, bf.clone(), bf.clone())
    with pytest.raises(ValueError, match="shape"):
        k14.project_stream(f, f.clone(), torch.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match="x stride"):
        k14.project_stream_masked(f, f.clone(), f.clone(),
                                  torch.ones((W, H, D)).transpose(0, 2))
    with pytest.raises(ValueError, match="nsw"):
        k14.project_stream_masked(f, f.clone(), f.clone(), ones_i, nsw=0)
    assert set(LAUNCHES.values()) == {0}


def test_keep_masks_may_be_views_of_padded_masks(card):
    """The step passes ``keep_vel[1:-1, 1:-1, 1:-1]``, a strided view: the
    wrappers take it without a copy, and the plain result follows."""
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2)
    m = build_masks(obs, device=CPU)
    kv = m.keep_vel[1:-1, 1:-1, 1:-1]
    assert not kv.is_contiguous()
    rng = np.random.default_rng(4)
    vel = [torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
           for _ in range(3)]
    smp = torch.stack([v[1:-1, 1:-1, 1:-1] for v in vel])
    got = (k2.project_masked(*vel, m.fluid_i, kv, acc=3)
           + k4.pad_bounds(smp, (1, 2, 3), fluid_i=m.fluid_i, keep_i=kv)
           + k10.confinement(*vel, kv, 5.0, 0.05)
           + (k1.rbgs_solve(1, vel[0], vel[1], 0.5, 4.0, acc=3,
                            keep=m.keep_vel),))
    want = (k2.project_masked_plain(*vel, m.fluid_i, kv, acc=3)
            + k4.pad_bounds_plain(smp, (1, 2, 3), fluid_i=m.fluid_i,
                                  keep_i=kv)
            + k10.confinement_plain(*vel, kv, 5.0, 0.05)
            + (k1.rbgs_solve_plain(1, vel[0], vel[1], 0.5, 4.0, 3,
                                   keep=m.keep_vel),))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert LAUNCHES == _counts(rbgs_solve_keep=1, project_masked=1,
                               pad_bounds_masked=1, confinement=1)


def test_wrapper_outputs_do_not_alias_inputs(card):
    rng = np.random.default_rng(3)
    vx, vy, vz, g = (torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
                     for _ in range(4))
    before = [t.clone() for t in (vx, vy, vz, g)]
    out1 = k1.rbgs_solve(1, vx, g, 0.5, 4.0, acc=2)
    out2 = k2.project_empty(vx, vy, vz, acc=2)
    out3 = k3.advect_split(torch.stack([vx, vy]), vx, vy, vz, 0.05)
    out4 = k4.pad_bounds(out3, (1, 2))
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2)
    m = build_masks(obs, device=CPU)
    kv = m.keep_vel[1:-1, 1:-1, 1:-1]
    out5 = k1.rbgs_solve(1, vx, g, 0.5, 4.0, acc=2, keep=m.keep_vel)
    out6 = k2.project_masked(vx, vy, vz, m.fluid_i, kv, acc=2)
    out7 = k4.pad_bounds(out3, (1, 2), fluid_i=m.fluid_i, keep_i=kv)
    out8 = k10.confinement(vx, vy, vz, kv, 5.0, 0.05)
    out9 = k11.rbgs_solve_stream(1, vx, g, 0.5, 4.0, acc=4)
    out10 = k11.rbgs_solve_stream(1, vx, g, 0.5, 4.0, acc=4,
                                  keep=m.keep_vel)
    out11 = k14.project_stream(vx, vy, vz, acc=3)
    out12 = k14.project_stream_masked(vx, vy, vz, m.fluid_i, acc=3)
    coords = [t[1:-1, 1:-1, 1:-1].contiguous() for t in (vx, vy, vz)]
    out13 = k9.trilinear_gather_window(g, *coords)
    out14 = k1.rbgs_solve3((1, 2, 3), vx, vy, vz, g, g.clone(), g.clone(),
                           0.5, 4.0, acc=2, keep=m.keep_vel)
    out15 = k1.rbgs_solve(1, vx, g, 0.5, 4.0, acc=2, keep=m.keep_vel,
                          packed=False)
    out16 = k3.advect_split_fused(torch.stack([vx, vy]), vx, vy, vz, 0.05)
    plane = g[0, 1:-1, 1:-1].contiguous()
    out17 = k15.rbgs_sweep_packed(
        1, vx[1:-1, 1:-1, 1:-1].contiguous(), g[1:-1, 1:-1, 1:-1], kv,
        *(t.contiguous() for t in (vx[1:-1, 1:-1, 0], vx[1:-1, 1:-1, -1],
                                   vx[1:-1, 0, 1:-1], vx[1:-1, -1, 1:-1])),
        plane, plane.clone(), plane.clone(), plane.clone(), 0.5, 4.0)
    out18 = k15.rbgs_sweep(2, vx, g, m.keep_vel, vy[0].clone(),
                           vy[-1].clone(), 0.5, 4.0)
    out19 = k22a.prestep(vx, vy, vz, None, None, 0.5, 4.0, acc=2)
    out20 = k22a.prestep(vx, vy, vz, m.fluid_i, kv, 0.5, 4.0, acc=2)
    out21 = k22c.rbgs_solve_blocked(1, vx, g, m.keep_vel, 0.5, 4.0, acc=1)
    out22 = k22b.rbgs_solve_cpack(1, vx, g, m.keep_vel, 0.5, 4.0, acc=2)
    out23 = k22b.rbgs_solve_cpack_stream(2, vy, g, None, 0.5, 4.0, acc=2,
                                         empty_scene=True)
    out24 = k23.add_one(g)
    out25 = k23h.stream_copy(vx, g, blk=4, halo=True, chain=True, hb=2)
    out26 = k23s.sweep_pass_variant(vx[1:-1, 1:-1, 1:-1].contiguous(),
                                    g[1:-1, 1:-1, 1:-1], "nosel", 2, 1, 0.5,
                                    4.0)
    out27 = k23d.dma_stream(vx, g, form="copy2h", blk=4, loader="ldg")
    out28 = k23t.transpose2d(vx[:, 3, :])
    out29 = k23t.strided_copy(vx.transpose(0, 1), 2.0)
    out30 = k3.lerp_pass(vx[None], vy, 1, 0.4, (0, 1, 0))
    out31 = k23m.rbgs_solve_mxu(vx, g, 0.5, 4.0, acc=2)
    stack, plane = torch.stack([vx, vy]).reshape(2, -1, W + 2), g.reshape(
        -1, W + 2) * 4.0 + 8.0
    out32 = k24.lerpcost_pass(stack, plane, "full")
    out33 = kst.step_stats(vx, vy, vz, g, m)
    out34 = k9.advect_compat(2, g, vx, vy, vz, m, 0.05, "noslip")
    out35 = k20.advect_fast(*(t[1:-1, 1:-1, 1:-1] for t in (vx, vy, vz)),
                            (vx, vy, g), 0.05)
    for a, b in zip((vx, vy, vz, g), before):
        assert torch.equal(a, b)
    for t in (out1, *out2, out5, *out6, *out8, out9, out10, out11, out12,
              out13, *out14, out15, out16, *out17, out18, *out19, *out20,
              out21, out22, out23, out24, out25, out26, out27, out28, out29,
              out30, out31, out32, *out33, out34, out35):
        assert t.data_ptr() not in {x.data_ptr() for x in (vx, vy, vz, g)}
    # the variants give what their plain versions give
    assert torch.equal(out13, trilinear_gather(g, *coords))
    for got, want in zip(out14, k1.rbgs_solve3_plain(
            (1, 2, 3), vx, vy, vz, g, g, g, 0.5, 4.0, 2, keep=m.keep_vel)):
        assert torch.equal(got, want)
    assert torch.equal(out15, out5)
    assert torch.equal(out16, out3)
    # the streamed wrappers give what their plain versions give
    assert torch.equal(out9, k11.rbgs_solve_stream_plain(1, vx, g, 0.5, 4.0,
                                                         4))
    assert torch.equal(out12, k14.project_stream_masked_plain(
        vx, vy, vz, m.fluid_i, acc=3))
    assert len(out4) == 2 and out4[0].shape == PAD
    assert len(out7) == 2 and out7[1].shape == PAD
    # the sharded sweeps give what their plain versions give
    assert torch.equal(out18, k15.rbgs_sweep_plain(
        2, vx, g, m.keep_vel, vy[0], vy[-1], 0.5, 4.0))
    assert len(out17) == 7 and out17[0].shape == INTERIOR
    # the retired kernels give what their plain versions give
    for got, want in zip(out19 + out20, k22a.prestep_plain(
            vx, vy, vz, None, None, 0.5, 4.0, 2) + k22a.prestep_plain(
            vx, vy, vz, m.fluid_i, kv, 0.5, 4.0, 2)):
        assert torch.equal(got, want)
    assert torch.equal(out21, k22c.rbgs_solve_blocked_plain(
        1, vx, g, m.keep_vel, 0.5, 4.0, 1))
    assert torch.equal(out22, k22b.rbgs_solve_cpack_plain(
        1, vx, g, m.keep_vel, 0.5, 4.0, 2))
    assert torch.equal(out23, k22b.rbgs_solve_cpack_stream_plain(
        2, vy, g, None, 0.5, 4.0, 2, empty_scene=True))
    assert torch.equal(out24, g + 1.0)
    # the probes' kernels give what their plain versions give
    assert torch.equal(out25, k23h.stream_copy_plain(vx, g, blk=4, halo=True,
                                                     chain=True, hb=2))
    assert torch.equal(out26, k23s.sweep_pass_variant_plain(
        vx[1:-1, 1:-1, 1:-1], g[1:-1, 1:-1, 1:-1], "nosel", 2, 1, 0.5, 4.0))
    assert torch.equal(out27, k23d.dma_stream_plain(vx, g, form="copy2h",
                                                    blk=4, loader="ldg"))
    assert torch.equal(out28, vx[:, 3, :].T)
    assert torch.equal(out29, vx.transpose(0, 1) * 2.0)
    assert torch.equal(out30, k3.lerp_pass_plain(vx[None], vy, 1, 0.4,
                                                 (0, 1, 0)))
    assert torch.equal(out31, k1.rbgs_solve_plain(0, vx, g, 0.5, 4.0, 2))
    assert torch.equal(out32, k24.lerpcost_pass_plain(stack, plane, "full"))
    # the statistics: the divergence bitwise, the sum the plain one
    for got, want in zip(out33, kst.step_stats_plain(vx, vy, vz, g, m)):
        assert torch.equal(got, want)
    assert torch.equal(out34, advect(2, g, vx, vy, vz, m, 0.05, "noslip"))
    # every wrapper once; the colour-packed solves' sweep 1 adds one K1
    # keep solve and one blocked sweep; the keep passes' count and their
    # tables' are the launchers', which the stubs replace
    assert LAUNCHES == {**{k: 1 for k in LAUNCHES}, "rbgs_solve_keep": 2,
                        "rbgs_solve_blocked": 2, "rbgs_pass_keep": 0,
                        "march_table": 0}


@pytest.mark.parametrize("masked", [False, True])
def test_prestep_is_one_launch(card, masked):
    """One call, one count of its own, no other counter: the chain's
    wrappers never run on the card's branch."""
    obs = add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2)
    m = build_masks(obs, device=CPU)
    fl, kv = (m.fluid_i, m.keep_vel[1:-1, 1:-1, 1:-1]) if masked else (None,
                                                                         None)
    rng = np.random.default_rng(8)
    vel = [torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
           for _ in range(3)]
    got = k22a.prestep(*vel, fl, kv, 0.5, 4.0, acc=3, wall_mode="noslip")
    for a, b in zip(got, k22a.prestep_plain(*vel, fl, kv, 0.5, 4.0, 3,
                                            "noslip")):
        assert torch.equal(a, b)
    name = "prestep_masked" if masked else "prestep"
    assert LAUNCHES == _counts(**{name: 1})


def test_blocked_solve_counts_its_sweeps(card):
    m = build_masks(add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2),
                    device=CPU)
    rng = np.random.default_rng(9)
    f, g = (torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
            for _ in range(2))
    got = k22c.rbgs_solve_blocked(0, f, g, m.keep_scalar, 1.0, 6.0, acc=5)
    assert torch.equal(got, k22c.rbgs_solve_blocked_plain(
        0, f, g, m.keep_scalar, 1.0, 6.0, 5))
    assert LAUNCHES == _counts(rbgs_solve_blocked=5)
    k22c.rbgs_solve_blocked(3, f, g, None, 0.8, 5.8, acc=4,
                            wall_mode="noslip", empty_scene=True)
    assert LAUNCHES == _counts(rbgs_solve_blocked=9)


def test_retired_kernels_raise_outside_their_gates(card, monkeypatch):
    """Outside the gate the card's branch raises; nothing runs the plain
    version or the chain in the kernel's place."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card's branch")

    monkeypatch.setattr(k22a, "prestep_plain", refuse)
    thin = torch.zeros((3, H + 2, W + 2))
    with pytest.raises(ValueError, match="gate"):
        k22a.prestep(thin, thin.clone(), thin.clone(), None, None, 0.5, 4.0)
    bf = torch.zeros(PAD, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A11"):
        k22a.prestep(bf, bf.clone(), bf.clone(), None, None, 0.5, 4.0)
    f = torch.zeros(PAD)
    with pytest.raises(ValueError, match="x stride"):
        k22a.prestep(f, f.clone(), f.clone(), torch.ones(INTERIOR),
                     torch.ones((W, H, D)).transpose(0, 2), 0.5, 4.0)
    with pytest.raises(ValueError, match="keep"):
        k22c.rbgs_solve_blocked(1, f, f.clone(), None, 0.5, 4.0)
    with pytest.raises(NotImplementedError, match="A11"):
        k22c.rbgs_solve_blocked(1, bf, bf.clone(), bf.clone(), 0.5, 4.0)
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("empty", [False, True])
def test_cpack_solve_counts(card, empty):
    """The resident entry point: sweep 1 through K1 (its own counter),
    then one count for the half-sweeps; the streamed one: sweep 1 through
    the blocked solve, then one count per colour-packed sweep. acc 1 runs
    sweep 1 only, acc 0 nothing."""
    m = build_masks(add_sphere(empty_obstacles(W, H, D), 5, 4, 4, 2),
                    device=CPU)
    keep = None if empty else m.keep_vel
    rng = np.random.default_rng(10)
    f, g = (torch.tensor(rng.normal(size=PAD), dtype=torch.float32)
            for _ in range(2))
    args = (2, f, g, keep, 0.5, 4.0)
    k1_name = "rbgs_solve" if empty else "rbgs_solve_keep"
    got = k22b.rbgs_solve_cpack(*args, acc=5, wall_mode="noslip",
                                empty_scene=empty)
    assert torch.equal(got, k1.rbgs_solve_plain(2, f, g, 0.5, 4.0, 5,
                                                "noslip", keep))
    assert LAUNCHES == _counts(**{k1_name: 1, "rbgs_solve_cpack": 1})
    reset_launches()
    got = k22b.rbgs_solve_cpack_stream(*args, acc=4, empty_scene=empty)
    assert torch.equal(got, k22b.rbgs_solve_cpack_stream_plain(
        *args, acc=4, empty_scene=empty))
    assert LAUNCHES == _counts(rbgs_solve_blocked=1,
                               rbgs_solve_cpack_stream=3)
    reset_launches()
    for solve in (k22b.rbgs_solve_cpack, k22b.rbgs_solve_cpack_stream):
        solve(*args, acc=0, empty_scene=empty)
    assert set(LAUNCHES.values()) == {0}
    k22b.rbgs_solve_cpack(*args, acc=1, empty_scene=empty)
    k22b.rbgs_solve_cpack_stream(*args, acc=1, empty_scene=empty)
    assert LAUNCHES == _counts(**{k1_name: 1, "rbgs_solve_blocked": 1})


def test_cpack_solve_refuses_on_the_card(card, monkeypatch):
    """Odd W, bf16, a missing keep and operands the kernels do not take
    raise on the card's branch; nothing runs a plain version in their
    place."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's branch")

    for name in ("_sweeps_plain", "rbgs_solve_plain",
                 "rbgs_solve_blocked_plain"):
        monkeypatch.setattr(k22b, name, refuse)
    f = torch.zeros(PAD)
    odd = torch.zeros((D + 2, H + 2, W + 1))
    bf = torch.zeros(PAD, dtype=torch.bfloat16)
    for solve in (k22b.rbgs_solve_cpack, k22b.rbgs_solve_cpack_stream):
        with pytest.raises(ValueError, match="even interior W"):
            solve(1, odd, odd.clone(), None, 0.5, 4.0, empty_scene=True)
        with pytest.raises(NotImplementedError, match="A11"):
            solve(1, bf, bf.clone(), None, 0.5, 4.0, empty_scene=True)
        with pytest.raises(ValueError, match="keep"):
            solve(1, f, f.clone(), None, 0.5, 4.0)
        with pytest.raises(ValueError, match="shape"):
            solve(1, f, f.clone(), torch.ones(INTERIOR), 0.5, 4.0)
        with pytest.raises(ValueError, match="contiguous"):
            solve(1, f, torch.zeros((W + 2, H + 2, D + 2)).transpose(0, 2),
                  None, 0.5, 4.0, empty_scene=True)
    assert set(LAUNCHES.values()) == {0}


def test_probe_counts_its_launches(card):
    """add_one is one launch; the probe's eager rows run their kernels
    through the wrappers, and none of them a plain version."""
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(k23.add_one(x), x + 1.0)
    assert LAUNCHES == _counts(probe_add1=1)
    reset_launches()
    for row in exp_overhead.rows(CPU, (W, H, D), 3):
        row.body()
    # (a) 1 + 4 + 16; (b) 1 + 3 + 1 + 1 + 1 solves; (d) 3 solves, 1
    # projection and one prestep
    assert LAUNCHES == _counts(probe_add1=21, rbgs_solve=10, project_empty=1,
                               prestep=1)
    with pytest.raises(NotImplementedError, match="A11"):
        k23.add_one(x.to(torch.bfloat16))


@pytest.mark.parametrize("kw", [dict(blk=16), dict(blk=32),
                                dict(blk=16, two=True),
                                dict(blk=8, two=True, halo=True),
                                dict(blk=16, two=True, halo=True,
                                     chain=True)])
def test_stream_copy_is_one_launch(card, kw):
    """Every form of the stream is one launch of its own counter, and the
    wrapper raises on what the kernel does not take."""
    kw = dict(kw)
    x = torch.arange(12 * 4 * 8, dtype=torch.float32).reshape(12, 4, 8)
    b = x.flip(0).contiguous() if kw.pop("two", False) else None
    assert torch.equal(k23h.stream_copy(x, b, **kw),
                       k23h.stream_copy_plain(x, b, **kw))
    assert LAUNCHES == _counts(hbm_stream=1)
    with pytest.raises(NotImplementedError, match="A11"):
        k23h.stream_copy(x.to(torch.bfloat16), None if b is None
                         else b.to(torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="shape"):
        k23h.stream_copy(x[0], None if b is None else b[0], **kw)
    assert LAUNCHES == _counts(hbm_stream=1)


@pytest.mark.parametrize("nsw", [1, 2])
@pytest.mark.parametrize("variant", list(k23s.VARIANTS))
def test_sweepcost_pass_is_one_launch(card, variant, nsw):
    rng = np.random.default_rng(5)
    f, g = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
            for s in (INTERIOR, PAD))
    rhs_i = g[1:-1, 1:-1, 1:-1]
    assert torch.equal(
        k23s.sweep_pass_variant(f, rhs_i, variant, nsw, 2, 0.5, 4.0,
                                "noslip"),
        k23s.sweep_pass_variant_plain(f, rhs_i, variant, nsw, 2, 0.5, 4.0,
                                      "noslip"))
    assert LAUNCHES == _counts(sweepcost_pass=1)
    with pytest.raises(ValueError, match="nsw"):
        k23s.sweep_pass_variant(f, rhs_i, variant, 3, 2, 0.5, 4.0)
    with pytest.raises(NotImplementedError, match="A11"):
        k23s.sweep_pass_variant(f.to(torch.bfloat16), rhs_i, variant, nsw,
                                2, 0.5, 4.0)
    assert LAUNCHES == _counts(sweepcost_pass=1)


def test_stream_probes_count_their_launches(card):
    """One call of every probe row: the streams and the variants through
    their wrappers, the production pass (prod1, rbgs_pass) uncounted, as
    ``sweep_pass`` is, and torch's own xla2 no kernel of the port."""
    for tool, want in ((exp_hbm, _counts(hbm_stream=5)),
                       (exp_hbm2, _counts(hbm_stream=3))):
        reset_launches()
        for row in tool.rows(CPU, (W, H, 2 * D)):
            row.step(row.x0)
        assert LAUNCHES == want, tool.__name__
    reset_launches()
    c0, variants, copy2hd = exp_sweepcost.rows(CPU, (W, H, 2 * D))
    for _, _, kernel, _ in variants:
        kernel(c0)
    copy2hd.step(c0)
    assert LAUNCHES == _counts(hbm_stream=1,
                               sweepcost_pass=2 * len(k23s.VARIANTS))


def test_launch_error_raises(monkeypatch):
    """A nonzero cudaGetLastError() from a C entry point is an exception."""
    class FakeLib:
        @staticmethod
        def fst_rbgs_half(*args):
            return 9

        @staticmethod
        def fst_error_string(code):
            return b"invalid configuration argument"

    _stub_library(monkeypatch, FakeLib)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.call("fst_rbgs_half", ctypes.c_void_p(0))


def _stub_library(monkeypatch, lib):
    """Stand ``lib`` in for the kernel library. Its entry points leave
    ``_build._ENTRY`` until the first lookup loads the library, which puts
    them there as ``library()`` does."""
    names = [n for n in vars(lib) if n.startswith("fst_")]
    for n in names:
        monkeypatch.delitem(_build._ENTRY, n, raising=False)

    def library():
        for n in names:
            monkeypatch.setitem(_build._ENTRY, n, getattr(lib, n))
        return lib

    monkeypatch.setattr(_build, "library", library)


@pytest.mark.parametrize("variant", list(k24.VARIANTS))
def test_lerpcost_pass_is_one_launch(card, variant):
    rng = np.random.default_rng(11)
    arr = torch.tensor(rng.normal(size=(3, 5, 130)), dtype=torch.float32)
    xb = torch.tensor(rng.uniform(-1.0, 130.0, size=(5, 128)),
                      dtype=torch.float32)
    assert torch.equal(k24.lerpcost_pass(arr, xb, variant),
                       k24.lerpcost_pass_plain(arr, xb, variant))
    assert LAUNCHES == _counts(lerpcost_pass=1)
    # every refusal of lane_lerp_stack and of the tool's bodies, before a
    # launch
    with pytest.raises(ValueError, match="row mismatch"):
        k24.lerpcost_pass(arr, xb[:-1], variant)
    with pytest.raises(ValueError, match="too wide"):
        k24.lerpcost_pass(torch.zeros(1, 2, 1665), torch.zeros(2, 4),
                          variant)
    with pytest.raises(ValueError, match="idx width"):
        k24.lerpcost_pass(arr[:, :, :100].contiguous(), xb[:, :98], variant)
    with pytest.raises(NotImplementedError, match="A11"):
        k24.lerpcost_pass(arr, xb.to(torch.bfloat16), variant)
    with pytest.raises(ValueError, match="not contiguous"):
        k24.lerpcost_pass(arr, xb.t().contiguous().t(), variant)
    if variant != "full":
        with pytest.raises(ValueError, match="at least 128"):
            k24.lerpcost_pass(arr, xb[:, :100], variant)
    assert LAUNCHES == _counts(lerpcost_pass=1)


def test_lerpcost_probe_counts_its_launches(card):
    """One call of every probe row: eight variant passes (four variants on
    two index planes) and K3's own x pass."""
    for row in exp_lerpcost.rows(CPU, (130, 6, 4)):
        row.kernel(row.x0)
    assert LAUNCHES == _counts(lerpcost_pass=8, lerp_pass=1)


class _Guard:
    """Stands for ``torch.cuda.device``: records the devices entered."""
    entered = []

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        _Guard.entered.append(self.index)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_card(monkeypatch):
    """``launch`` on a host without a card: a current device 0, a raw
    stream handle that changes at every read, a recording device guard and
    a recording entry point."""
    reads, calls = [], []

    def raw_stream(index):
        reads.append(index)
        return 1000 * index + len(reads)

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(_Guard, "entered", [])
    monkeypatch.setitem(_build._ENTRY, "fst_fake",
                        lambda *args: calls.append(args) or 0)
    return reads, calls


def test_launch_reads_the_stream_at_each_call(fake_card):
    reads, calls = fake_card
    x = torch.zeros(3)
    _build.launch("fst_fake", 0, _build.ptr(x), 7, 0.5)
    _build.launch("fst_fake", 0, None, 8, 1.5)
    # the stream read at each call, appended last; pointers as plain ints
    assert calls == [(x.data_ptr(), 7, 0.5, 1), (None, 8, 1.5, 2)]
    assert reads == [0, 0]
    assert isinstance(_build.ptr(x), int)
    assert _Guard.entered == []          # on the current device: no guard


def test_launch_guards_only_off_the_current_device(fake_card):
    reads, calls = fake_card
    _build.launch("fst_fake", 1, 5)
    _build.launch("fst_fake", 0, 6)
    assert _Guard.entered == [1]
    assert reads == [1, 0]
    assert calls == [(5, 1001), (6, 2)]


def test_launch_error_raises_through_the_helper(fake_card, monkeypatch):
    """A nonzero cudaGetLastError() from a launch is an exception, and an
    entry point the dict does not hold yet is found by loading the
    library."""
    class FakeLib:
        @staticmethod
        def fst_rbgs_half(*args):
            return 9

        @staticmethod
        def fst_error_string(code):
            return b"invalid configuration argument"

    _stub_library(monkeypatch, FakeLib)
    monkeypatch.setitem(_build._ENTRY, "fst_fake", lambda *args: 700)
    with pytest.raises(RuntimeError, match="fst_rbgs_half: CUDA error 9"):
        _build.launch("fst_rbgs_half", 0, 0)
    with pytest.raises(RuntimeError, match="fst_fake: CUDA error 700"):
        _build.launch("fst_fake", 1, 0)


def test_check_refusal_messages(monkeypatch):
    """Every refusal of ``check_operands`` and ``mask_view``, word for
    word."""
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match=r"^k: operand 0 on cpu, expected "
                       r"the card \(cpu\)$"):
        _build.check_operands("k", (x,))
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    with pytest.raises(NotImplementedError, match=(
            r"^k: torch.bfloat16 is not ported to the card yet \(ROADMAP "
            r"A11\); this kernel takes torch.float32$")):
        _build.check_operands("k", (x, x.to(torch.bfloat16)))
    with pytest.raises(ValueError, match=r"^k: operand 1 is not contiguous$"):
        _build.check_operands("k", (x, x.t()))
    with pytest.raises(ValueError, match=(r"^k: operand 1 has shape \(2, "
                                          r"3\), expected \(3, 2\)$")):
        _build.check_operands("k", (x, x), (None, [3, 2]))
    _build.check_operands("k", (x, x.to(torch.bfloat16)), (x.shape, (2, 3)),
                          dtypes=(torch.float32, torch.bfloat16))
    m = torch.zeros(4, 5, 6)
    with pytest.raises(ValueError, match=r"^k: mask on cpu, expected "
                       r"cuda:0$"):
        _build.mask_view("k", m, (4, 5, 6), 0)
    with pytest.raises(NotImplementedError, match=(
            r"^k: torch.float64 mask is not ported to the card yet \(ROADMAP"
            r" A11\); only float32 kernels exist$")):
        _build.mask_view("k", m.double(), (4, 5, 6), -1)
    with pytest.raises(ValueError, match=r"x stride 1$"):
        _build.mask_view("k", m.transpose(1, 2), (4, 6, 5), -1)
    with pytest.raises(ValueError, match=r"expected \(4, 5, 7\)"):
        _build.mask_view("k", m, [4, 5, 7], -1)
    big = torch.zeros(6, 7, 8)
    assert _build.mask_view("k", big[1:-1, 1:-1, 1:-1], (4, 5, 6), -1) == (
        big[1:-1, 1:-1, 1:-1].data_ptr(), 56, 8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler is a hard error at first use, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_sources_and_sign_mask():
    names = {s.name for s in _build.sources()}
    assert {"rbgs.cu", "project.cu", "advect_split.cu", "pad_bounds.cu",
            "vorticity.cu", "rbgs_stream.cu", "project_stream.cu",
            "trilinear.cu", "advect_compat.cu", "advect_fast.cu",
            "rbgs_sweep.cu",
            "prestep.cu",
            "rbgs_cpack.cu", "probe.cu", "hbm.cu", "sweepcost.cu", "dma.cu",
            "transpose.cu", "rbgs_mxu.cu", "lerpcost.cu",
            "rbgs_tile.cuh", "common.cuh"} <= names
    assert len(_build.source_hash()) == 16
    # field 0 x-negated, field 1 y-negated, field 2 z-negated
    assert _build.neg_mask([(-1.0, 1.0, 1.0), (1.0, -1.0, 1.0),
                            (1.0, 1.0, -1.0)]) == 0b100_010_001
