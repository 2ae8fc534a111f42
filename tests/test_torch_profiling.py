"""The port's profiling helpers on the CPU: the busy-time arithmetic, the
step's phases from a profile's rows, the trace exporter, and the refusal
to report a device metric without a card."""

import json

import pytest
import torch

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.parallel import ShardedWindTunnel
from fluid_simulation_tpu_torch.utils.profiling import (
    BIG_SPHERES, big_sphere, busy_us, cells, host_ms, main, make_tunnel,
    phase_table, shard_cells, step_breakdown, trace_ctx)

torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),          # a gap is idle
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 5.0)], 5.0),  # overlaps count once
    ([(3.0, 5.0), (0.0, 1.0), (1.0, 3.0)], 5.0),  # any order, touching
])
def test_busy_us_is_union_length(intervals, want):
    assert busy_us(intervals) == want


def test_step_breakdown_refuses_cpu():
    wt = WindTunnel(SimParams(width=8, height=4, depth=4, acc=2), device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        step_breakdown(wt, steps=1, warmup=0)


def test_host_ms_refuses_cpu():
    wt = WindTunnel(SimParams(width=8, height=4, depth=4, acc=2), device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        host_ms(wt, steps=1, warmup=0)


def test_cells_are_the_slice_on_the_kernel_path():
    c = cells()
    assert list(c) == ["split 128x64x64", "compat 128x64x64",
                       "split 256x128x128", "split 128x64x64 sphere",
                       "split 128x64x64 noslip+vorticity"]
    assert all(p.use_pallas and p.solver == "rbgs" and p.dtype == "float32"
               for p, _ in c.values())
    assert c["compat 128x64x64"] == (SimParams(div_stats=False,
                                               step_stats=False), None)
    split, _ = c["split 128x64x64"]
    # the JAX bench's obstacle_sphere and noslip_vorticity (bench.py:224-228)
    p, obs = c["split 128x64x64 sphere"]
    assert p == split and obs.shape == split.padded_shape
    assert obs[32, 32, 40] == 1.0 and int(obs.sum()) == 4169
    assert c["split 128x64x64 noslip+vorticity"] == (
        split.replace(wall_mode="noslip", vorticity=5.0), None)
    assert not any(p.vorticity for label, (p, _) in c.items()
                   if "vorticity" not in label)


def test_big_grids_are_the_bench_configs():
    """The big cells' grids and spheres are the JAX bench's (bench.py:
    227-263); only the 256x128x128 sphere is built here, the others cost a
    GB of host memory."""
    assert list(BIG_SPHERES) == [(256, 128, 128), (256, 256, 256),
                                 (512, 256, 256)]
    assert BIG_SPHERES[(256, 256, 256)] == BIG_SPHERES[(512, 256, 256)] == \
        dict(cx=48, cy=128, cz=128, radius=40)
    obs = big_sphere(256, 128, 128)
    assert obs.shape == (130, 130, 258)
    assert obs[64, 64, 85] == 1.0 and obs[64, 64, 106] == 0.0
    assert obs[0].sum() == obs[:, 0].sum() == obs[..., 0].sum() == 0.0


def test_shards_flag_builds_sharded_tunnels():
    """``--shards N``: the cells run as ShardedWindTunnels over N slabs,
    every rank on one device, and a step breakdown of one refuses the CPU
    as the single-device one does."""
    p = SimParams(width=8, height=4, depth=4, acc=2, mode="split")
    wt = make_tunnel(p, None, 2, device=CPU)
    assert isinstance(wt, ShardedWindTunnel)
    assert [str(d) for d in wt.devices] == [CPU, CPU]
    assert isinstance(make_tunnel(p, None, 0, device=CPU), WindTunnel)
    with pytest.raises(RuntimeError, match="CUDA"):
        host_ms(wt, steps=1, warmup=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        step_breakdown(wt, steps=1, warmup=0)
    todo = {k: v for k, v in cells().items() if k == "compat 128x64x64"}
    assert list(shard_cells(todo, 2)) == ["compat 128x64x64 / 2 slabs"]
    with pytest.raises(SystemExit, match="divisible"):
        shard_cells(todo, 3)


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--shards", "2", "--wall-only"])


def test_phase_table_gives_each_call_to_the_innermost_span():
    """Two profiled calls of a step: runtime calls and the device ops they
    launched (by correlation id) go to the innermost span open when the
    call started; blocking calls leave the span's self time; what was
    launched outside every span, or by no call in the profile, has rows of
    its own."""
    host = [("fst.step", 0.0, 1000.0, 1),
            ("fst.project", 100.0, 500.0, 2),
            ("fst.bounds", 300.0, 400.0, 3),
            ("cudaLaunchKernel", 150.0, 160.0, 10),
            ("cudaLaunchKernel", 310.0, 320.0, 11),
            ("cudaStreamSynchronize", 600.0, 900.0, 12),
            ("aten::add", 620.0, 640.0, 13),
            ("fst.step", 2000.0, 2500.0, 4),
            ("fst.project", 2100.0, 2200.0, 5),
            ("cudaMemcpyAsync", 2150.0, 2160.0, 14),
            ("cudaLaunchKernel", 3000.0, 3010.0, 15)]
    dev = [("k1", 5000.0, 5100.0, 10), ("k2", 5100.0, 5300.0, 11),
           ("copy", 5300.0, 5310.0, 14), ("k3", 5400.0, 5440.0, 15),
           ("k4", 5500.0, 5501.0, 99)]
    got = phase_table(host, dev, 2)
    assert list(got) == ["fst.step", "fst.project", "fst.bounds",
                         "(no span)", "(not matched)"]
    ms = 1 / 2e3    # us over two calls, in ms
    assert got["fst.step"] == pytest.approx(dict(
        calls=1.0, self_ms=(1000 - 400 - 300 + 500 - 100) * ms,
        blocked_ms=300 * ms, launches=0.0, device_ms=0.0))
    assert got["fst.project"] == pytest.approx(dict(
        calls=1.0, self_ms=(400 - 100 + 100) * ms, blocked_ms=0.0,
        launches=1.0, device_ms=(100 + 10) * ms))
    assert got["fst.bounds"] == pytest.approx(dict(
        calls=0.5, self_ms=100 * ms, blocked_ms=0.0, launches=0.5,
        device_ms=200 * ms))
    assert got["(no span)"]["device_ms"] == pytest.approx(40 * ms)
    assert got["(not matched)"]["device_ms"] == pytest.approx(1 * ms)
    assert sum(r["device_ms"] for r in got.values()) == pytest.approx(
        sum(e - s for _, s, e, _ in dev) * ms)


def test_trace_ctx_writes_the_step_spans(tmp_path):
    wt = WindTunnel(SimParams(width=8, height=4, depth=4, acc=2,
                              mode="split"), device=CPU)
    path = tmp_path / "step.json"
    with trace_ctx(str(path)):
        wt.step()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"fst.step", "fst.project", "fst.stats"} <= names
    with trace_ctx(None):                        # no-op path
        wt.step()
    assert list(tmp_path.iterdir()) == [path]


def test_trace_out_needs_one_cell():
    with pytest.raises(SystemExit, match="one cell"):
        main(["--trace-out", "trace.json"])
    with pytest.raises(SystemExit, match="one cell"):
        main(["--trace-out", "trace.json", "--cells", "split 128x64x64",
              "compat 128x64x64"])
