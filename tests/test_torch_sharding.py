"""The port's sharded wind tunnel (``parallel/``) on the CPU: against the JAX
``ShardedWindTunnel`` on the suite's virtual CPU devices, against the port's
own single-device step, its layout helpers and routes, and its CUDA branch
with the sweep launcher stubbed.

Tolerances. Against JAX: ``5e-5·max|field|``, the JAX suite's own bound for
sharded against single (tests/test_sharding.py:45-51). The two start from
one state (two JAX steps from rest, carried with
``convert.sharded_state_from_numpy``) and take two steps each; XLA contracts
some ``a*b + c`` into fused multiply-adds where torch rounds each operation,
and the measured gap is at most 3.4e-6 of the field maximum. Against the
port's single-device step: bitwise, every field of every case (the sharded
step evaluates the same torch operations per cell in the same order, and
the advection windows take their lerp fractions from global coordinates);
the density sums are f32 sums in another order, 1e-6 relative.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from fluid_simulation_tpu.config import SimParams as JaxSimParams
from fluid_simulation_tpu.kernels import linsolve_sweep as jax_sweep
from fluid_simulation_tpu.parallel.sharded import (
    ShardedWindTunnel as JaxShardedWindTunnel)
from fluid_simulation_tpu.scene.primitives import add_sphere, empty_obstacles
from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.convert import (
    sharded_state_from_numpy, sharded_state_to_numpy)
from fluid_simulation_tpu_torch.kernels import (
    LAUNCHES, _build, linsolve_sweep as k15, reset_launches)
from fluid_simulation_tpu_torch.parallel import (
    ShardedWindTunnel, make_mesh, simulate_sharded, split_padded,
    stitch_padded)
from fluid_simulation_tpu_torch.parallel import sharded as shm

torch.set_num_threads(1)

W, H, D = 16, 8, 8
PARAMS = dict(width=W, height=H, depth=D, acc=6)
SPHERE = add_sphere(empty_obstacles(W, H, D), cx=8, cy=4, cz=4, radius=2.5)


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("change,n,packed", [
    (dict(mode="split"), 2, False),
    (dict(mode="compat", vorticity=4.0), 4, False),
    (dict(mode="fast"), 4, False),
    (dict(advect_halo_slabs=1), 4, False),   # the gather fallback fires
    (dict(), 2, True),                       # the JAX side on its kernel
])
def test_sharded_step_matches_jax(change, n, packed):
    if jax.device_count() < n:
        pytest.skip("not enough virtual devices")
    kw = dict(PARAMS, **change)
    jax_sweep.FORCE_INTERPRET = packed
    try:
        jt = JaxShardedWindTunnel(JaxSimParams(**kw), obstacles=SPHERE,
                                  n_devices=n)
        if packed:
            assert jt.backend_report()["solve"] == "pallas_packed_sweep"
        jt.simulate(2)
        tt = ShardedWindTunnel(SimParams(**kw), obstacles=SPHERE,
                               devices=_cpu(n))
        tt.state = sharded_state_from_numpy(
            [np.asarray(f) for f in jt.state], tt.devices)
        _, jstats = jt.simulate(2)
    finally:
        jax_sweep.FORCE_INTERPRET = False
    _, tstats = tt.simulate(2)
    for name, got, want in zip(("vx", "vy", "vz", "dens"),
                               sharded_state_to_numpy(tt.state), jt.state):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(tstats.density_sum.numpy(),
                               np.asarray(jstats.density_sum), rtol=1e-5)
    np.testing.assert_allclose(tstats.max_divergence.numpy(),
                               np.asarray(jstats.max_divergence), rtol=1e-4)


CASES = [(mode, scene, n) for mode in ("compat", "split", "fast")
         for scene, n in ((None, 2), ("sphere", 1), ("sphere", 4))]


@pytest.mark.parametrize("mode,scene,n,change", [
    c + ({},) for c in CASES] + [
    ("split", "sphere", 4, dict(solver="jacobi")),
    ("split", "sphere", 2, dict(use_pallas=False)),
    ("split", None, 4, dict(wall_mode="noslip", vorticity=5.0)),
    ("compat", "sphere", 4, dict(advect_halo_slabs=0)),
])
def test_sharded_matches_single_device_bitwise(mode, scene, n, change):
    p = SimParams(mode=mode, **PARAMS, **change)
    obs = SPHERE if scene else None
    ref = WindTunnel(p, obstacles=obs, device="cpu")
    _, ref_stats = ref.simulate(4)
    sw = ShardedWindTunnel(p, obstacles=obs, devices=_cpu(n))
    _, stats = sw.simulate(4)
    for name, a, b in zip(("vx", "vy", "vz", "dens"), ref.state,
                          sw.global_state()):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(stats.density_sum.numpy(),
                               ref_stats.density_sum.numpy(), rtol=1e-6)
    np.testing.assert_allclose(stats.max_divergence.numpy(),
                               ref_stats.max_divergence.numpy(), rtol=1e-6)


def test_window_and_fallback_both_run(monkeypatch):
    """With a one-slab window over four ranks (two rows each), a state
    whose z velocities reach several slabs makes the gather fallback fire,
    and a calm one lets the window serve; the state is the single-device
    one either way."""
    calls = {"window": 0, "gather": 0}
    window, gather = shm._bounded_z_window, shm._gather_global

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(shm, "_bounded_z_window", count("window", window))
    monkeypatch.setattr(shm, "_gather_global", count("gather", gather))
    p = SimParams(advect_halo_slabs=1, **PARAMS)
    for vz_scale, key in ((0.0, "window"), (20.0, "gather")):
        rng = np.random.default_rng(3)
        # ghost edges and corners zero, as in every state of a run (the
        # packed sweep rebuilds them as zeros)
        shell = np.zeros(p.padded_shape, np.float32)
        shell[1:-1, 1:-1, :] = shell[1:-1, :, 1:-1] = 1.0
        shell[:, 1:-1, 1:-1] = 1.0
        g = [rng.uniform(-2, 2, size=p.padded_shape).astype(np.float32)
             * shell for _ in range(4)]
        g[2] *= vz_scale
        sw = ShardedWindTunnel(p, obstacles=SPHERE, devices=_cpu(4))
        sw.state = sharded_state_from_numpy(
            [np.stack(split_padded(f, 4)) for f in g], sw.devices)
        ref = WindTunnel(p, obstacles=SPHERE, device="cpu")
        ref.state = ref.state._replace(**{
            k: torch.from_numpy(f) for k, f in zip(("vx", "vy", "vz",
                                                     "dens"), g)})
        before = dict(calls)
        sw.simulate(2)
        ref.simulate(2)
        assert calls[key] > before[key], (key, calls)
        for a, b in zip(ref.state, sw.global_state()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("b,wall_mode", [(1, "reference"), (0, "noslip")])
def test_padded_sweep_runs_the_sharded_protocol(b, wall_mode):
    """B20's plain version in the sharded protocol: each rank's padded
    sweep, reading the padded black-phase planes, then the post-bounds z
    exchange, equals one plain sharded rbgs sweep bitwise."""
    p = SimParams(use_pallas=False, wall_mode=wall_mode,
                  **dict(PARAMS, acc=1))
    n = 4
    rng = np.random.default_rng(8)
    shell = np.zeros(p.padded_shape, np.float32)
    shell[1:-1, 1:-1, :] = shell[1:-1, :, 1:-1] = 1.0
    shell[:, 1:-1, 1:-1] = 1.0
    f, q = (torch.from_numpy(rng.normal(size=p.padded_shape).astype(
        np.float32) * shell) for _ in range(2))
    fs, prevs = split_padded(f, n), split_padded(q, n)
    solids = split_padded(torch.from_numpy((SPHERE >= 0.5).astype(
        np.float32)), n)
    lms = [shm._local_masks(s, n, r, D) for r, s in enumerate(solids)]
    keeps = [lm.keep_vel if b else lm.keep_scalar for lm in lms]
    a, c = 0.7, 5.2
    want = shm._solve(b, fs, prevs, a, c, lms, keeps, p)
    a_c, crec = k15._coeffs(a, c, torch.float32)
    bps = shm._black_phase_planes_padded(fs, prevs, a_c, crec,
                                         *shm._edge_parity(fs))
    outs = [k15.rbgs_sweep(b, f, q, k, lo, hi, a, c, wall_mode)
            for f, q, k, (lo, hi) in zip(fs, prevs, keeps, bps)]
    from_prev, from_next = shm._ppermute_updown([o[-2] for o in outs],
                                                [o[1] for o in outs])
    for r, o in enumerate(outs):
        if r > 0:
            o[0] = from_prev[r]
        if r < n - 1:
            o[-1] = from_next[r]
    for r, (got, exp) in enumerate(zip(outs, want)):
        assert torch.equal(got, exp), r


def test_record_frames_are_the_single_device_frames():
    p = SimParams(mode="split", **PARAMS)
    sw = ShardedWindTunnel(p, obstacles=SPHERE, devices=_cpu(2))
    _, (stats, frames) = sw.simulate(3, record=True)
    ref = WindTunnel(p, obstacles=SPHERE, device="cpu")
    _, (_, ref_frames) = ref.simulate(3, record=True)
    assert stats.density_sum.shape == (3,)
    for got, want in zip(frames, ref_frames):
        assert got.shape == (3, D + 2, H + 2, W + 2)
        np.testing.assert_array_equal(got, want.numpy())


def test_split_stitch_roundtrip():
    g = np.random.default_rng(0).normal(size=(10, 6, 7)).astype(np.float32)
    s = split_padded(g, 4)
    assert len(s) == 4 and s[0].shape == (4, 6, 7)
    np.testing.assert_array_equal(stitch_padded(s), g)
    np.testing.assert_array_equal(stitch_padded(np.stack(s)), g)
    t = torch.from_numpy(g)
    assert torch.equal(stitch_padded(split_padded(t, 2)), t)
    with pytest.raises(ValueError, match="divisible"):
        split_padded(g, 3)


def test_sharded_state_conversion_roundtrip():
    rng = np.random.default_rng(1)
    fields = [rng.normal(size=(4, 4, 10, 18)).astype(np.float32)
              for _ in range(4)]
    states = sharded_state_from_numpy(fields, _cpu(4))
    assert len(states) == 4 and states[2].vz.shape == (4, 10, 18)
    for a, b in zip(sharded_state_to_numpy(states), fields):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="devices"):
        sharded_state_from_numpy(fields, _cpu(2))


def test_global_sum_counts_each_ghost_plane_once():
    """The density sum of a step is the f32 sum of the stitched field: the
    edge ranks alone add the global ghost planes."""
    sw = ShardedWindTunnel(SimParams(mode="split", **PARAMS),
                           obstacles=SPHERE, devices=_cpu(4))
    rng = np.random.default_rng(2)
    g = [rng.uniform(0, 1, size=(D + 2, H + 2, W + 2)).astype(np.float32)
         for _ in range(4)]
    sw.state = sharded_state_from_numpy([np.stack(split_padded(f, 4))
                                         for f in g], sw.devices)
    stats = sw.step()
    want = torch.sum(sw.global_state().dens, dtype=torch.float32)
    np.testing.assert_allclose(float(stats.density_sum), float(want),
                               rtol=1e-6)


@pytest.mark.parametrize("n,change", [
    (4, {}), (2, dict(solver="jacobi")), (4, dict(vorticity=2.0)),
    (4, dict(advect_halo_slabs=0)), (8, dict(advect_halo_slabs=2))])
def test_collective_bytes_match_jax(n, change):
    if jax.device_count() < n:
        pytest.skip("not enough virtual devices")
    kw = dict(PARAMS, **change)
    want = JaxShardedWindTunnel(JaxSimParams(**kw),
                                n_devices=n).collective_bytes_per_step()
    got = ShardedWindTunnel(SimParams(**kw),
                            devices=_cpu(n)).collective_bytes_per_step()
    assert got == want


def test_backend_report():
    r = ShardedWindTunnel(SimParams(**PARAMS), devices=_cpu(4)
                          ).backend_report()
    assert r["mesh"] == (4, 1) and r["local_padded_shape"] == (4, 10, 18)
    assert r["solve"] == "plain_rbgs" and "CPU" in r["solve_reason"]
    r = ShardedWindTunnel(SimParams(**dict(PARAMS, depth=12)),
                          devices=_cpu(4)).backend_report()
    assert r["solve"] == "plain_rbgs" and "odd local slab depth 3" in (
        r["solve_reason"])
    r = ShardedWindTunnel(SimParams(**dict(PARAMS, use_pallas=False)),
                          devices=_cpu(4)).backend_report()
    assert r["solve_reason"] == "use_pallas=False"
    r = ShardedWindTunnel(SimParams(**dict(PARAMS, solver="jacobi")),
                          devices=_cpu(2)).backend_report()
    assert "rbgs only" in r["solve_reason"]


def test_make_mesh():
    m = make_mesh(devices=_cpu(8))
    assert m.axis_names == ("batch", "z") and m.shape == (1, 8)
    assert make_mesh(n_devices=3, devices=_cpu(8)).shape == (1, 3)
    with pytest.raises(ValueError):
        make_mesh(n_devices=6, batch=4, devices=_cpu(8))
    with pytest.raises(NotImplementedError, match="A12"):
        make_mesh(n_devices=8, batch=2, devices=_cpu(8))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedWindTunnel(SimParams(**PARAMS))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


@pytest.mark.parametrize("positional", [False, True])
def test_n_devices_takes_the_first_devices(positional):
    """The JAX signature: ``n_devices`` picks the first n of ``devices``,
    by keyword or in the third position, and one step equals the run given
    just those devices, bitwise."""
    p = SimParams(**PARAMS)
    sw = (ShardedWindTunnel(p, None, 2, devices=_cpu(4)) if positional else
          ShardedWindTunnel(p, n_devices=2, devices=_cpu(4)))
    assert sw.nz == 2 and len(sw.devices) == 2 and len(sw.state) == 2
    ref = ShardedWindTunnel(p, devices=_cpu(2))
    rng = np.random.default_rng(6)
    fields = [rng.uniform(-1, 1, size=(2,) + sw.state[0].vx.shape)
              .astype(np.float32) for _ in range(4)]
    sw.state = sharded_state_from_numpy(fields, sw.devices)
    ref.state = sharded_state_from_numpy(fields, ref.devices)
    sw.step()
    ref.step()
    for got, want in zip(sharded_state_to_numpy(sw.state),
                         sharded_state_to_numpy(ref.state)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="n_devices"):
        ShardedWindTunnel(p, n_devices=5, devices=_cpu(4))


def test_two_d_mesh_raises_everywhere():
    with pytest.raises(NotImplementedError, match="A13b"):
        ShardedWindTunnel(SimParams(**PARAMS), devices=_cpu(4),
                          mesh_shape=(2, 2))


# -- the CUDA branch, forced on for CPU tensors ------------------------------

def _operand(t, shape):
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert tuple(t.shape) == tuple(shape), (tuple(t.shape), shape)


def stub_packed(ins, rp, kp, outs, f1, b, a, c, wall_mode):
    fk = ins[0]
    Dl, Hh, Ww = fk.shape
    for t, s in zip(ins + outs + (f1,),
                    ((Dl, Hh, Ww), (Dl, Hh), (Dl, Hh), (Dl, Ww), (Dl, Ww))
                    + ((Hh, Ww),) * 4 + ((Dl, Hh, Ww), (Dl, Hh), (Dl, Hh),
                                         (Dl, Ww), (Dl, Ww), (Hh, Ww),
                                         (Hh, Ww), (Dl, Hh, Ww))):
        _operand(t, s)
    for m in (rp, kp):
        assert tuple(m.shape) == (Dl, Hh, Ww) and m.stride(2) == 1
    ptrs = [t.data_ptr() for t in ins + outs + (f1,)]
    assert len(set(ptrs)) == len(ptrs), "launcher operands alias"
    for dst, src in zip(outs, k15.rbgs_sweep_packed_plain(
            b, *ins[:1], rp, kp, *ins[1:], a, c, wall_mode)):
        dst.copy_(src)


def stub_padded(out, prev, keep, bp_lo, bp_hi, b, a, c, wall_mode):
    for t in (out, prev) + (() if keep is None else (keep,)):
        _operand(t, out.shape)
    for t in (bp_lo, bp_hi):
        _operand(t, out.shape[1:])
    out.copy_(k15.rbgs_sweep_plain(
        b, out, prev, torch.ones_like(out) if keep is None else keep, bp_lo,
        bp_hi, a, c, wall_mode, apply_keep=keep is not None))


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(k15, "_launch_packed", stub_packed)
    monkeypatch.setattr(k15, "_launch_padded", stub_padded)
    reset_launches()
    yield
    reset_launches()


@pytest.mark.parametrize("n,mode,scene", [(2, "split", "sphere"),
                                          (4, "compat", None),
                                          (1, "fast", "sphere")])
def test_card_route_launches_the_packed_sweep(card, n, mode, scene):
    """Every sweep of the five solves per step is one rbgs_sweep_packed call
    per rank (5·acc·n per step), no other kernel counts, and the state
    equals the plain torch sharded step (use_pallas=False) bitwise."""
    p = SimParams(mode=mode, **PARAMS)
    obs = SPHERE if scene else None
    sw = ShardedWindTunnel(p, obstacles=obs, devices=_cpu(n))
    sw.simulate(2)
    assert LAUNCHES == {k: (2 * 5 * p.acc * n if k == "rbgs_sweep_packed"
                            else 0) for k in LAUNCHES}
    reset_launches()
    plain = ShardedWindTunnel(p.replace(use_pallas=False), obstacles=obs,
                              devices=_cpu(n))
    plain.simulate(2)
    assert set(LAUNCHES.values()) == {0}
    for a, b in zip(sw.global_state(), plain.global_state()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change,match", [
    (dict(depth=12), "A13b"),                 # odd slab depth 3 on 4 ranks
    (dict(dtype="bfloat16"), "A11"),
    (dict(batched=True), "A12")])
def test_unported_config_raises_on_card(card, change, match):
    p = SimParams(**dict(PARAMS, **change))
    with pytest.raises(NotImplementedError, match=match):
        ShardedWindTunnel(p, devices=_cpu(4))
    # simulate_sharded itself refuses too
    sw = ShardedWindTunnel(p.replace(use_pallas=False), devices=_cpu(4))
    with pytest.raises(NotImplementedError, match=match):
        simulate_sharded(sw.state, sw.solids, p, 1)
    assert set(LAUNCHES.values()) == {0}


def test_sweep_wrappers_on_the_card_branch(card):
    """Both wrappers check their operands, count one launch per call and
    give the plain result; the padded one ignores keep without apply_keep."""
    rng = np.random.default_rng(5)
    pad = (6, H + 2, W + 2)
    field, prev = (torch.tensor(rng.normal(size=pad), dtype=torch.float32)
                   for _ in range(2))
    keep = torch.tensor(rng.uniform(size=pad) > 0.2, dtype=torch.float32)
    bps = [torch.tensor(rng.normal(size=pad[1:]), dtype=torch.float32)
           for _ in range(2)]
    for ak in (True, False):
        got = k15.rbgs_sweep(2, field, prev, keep, *bps, 0.7, 5.2, "noslip",
                             ak)
        assert torch.equal(got, k15.rbgs_sweep_plain(
            2, field, prev, keep, *bps, 0.7, 5.2, "noslip", ak))
    i = (slice(1, -1),) * 2
    planes = [field[1:-1, 1:-1, 0].contiguous(),
              field[1:-1, 1:-1, -1].contiguous(),
              field[1:-1, 0, 1:-1].contiguous(),
              field[1:-1, -1, 1:-1].contiguous(),
              field[0][i].contiguous(), field[-1][i].contiguous(),
              bps[0][i].contiguous(), bps[1][i].contiguous()]
    fk = field[1:-1, 1:-1, 1:-1].contiguous()
    args = (3, fk, prev[1:-1, 1:-1, 1:-1], keep[1:-1, 1:-1, 1:-1], *planes,
            0.7, 5.2)
    for got, want in zip(k15.rbgs_sweep_packed(*args),
                         k15.rbgs_sweep_packed_plain(*args)):
        assert torch.equal(got, want)
    assert LAUNCHES == {k: {"rbgs_sweep": 2, "rbgs_sweep_packed": 1}.get(k, 0)
                        for k in LAUNCHES}
    with pytest.raises(ValueError, match="contiguous"):
        k15.rbgs_sweep_packed(3, fk, *args[2:5], field[1:-1, 1:-1, -1],
                              *planes[2:], 0.7, 5.2)
    with pytest.raises(ValueError, match="shape"):
        k15.rbgs_sweep(0, field, prev, keep, bps[0], F.pad(bps[1], (0, 1)),
                       0.7, 5.2)
    with pytest.raises(NotImplementedError, match="A11"):
        k15.rbgs_sweep(0, field.bfloat16(), prev, keep, *bps, 0.7, 5.2)
