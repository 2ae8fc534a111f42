"""The port's profiling helpers on the CPU: the busy-time arithmetic, and the
refusal to report a device metric without a card."""

import pytest
import torch

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.parallel import ShardedWindTunnel
from fluid_simulation_tpu_torch.utils.profiling import (
    BIG_SPHERES, big_sphere, busy_us, cells, host_ms, main, make_tunnel,
    shard_cells, step_breakdown)

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
