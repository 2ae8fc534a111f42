"""The readers of the program's ``fst.gather`` spans (each trilinear sample
of compat and fast advection, ``ops/advect.gather``): on synthetic rows,
where launches inside and outside the gathers and a blocking call inside
one show; in a traced compat run on the CPU at 24x12x10; and on the card,
where the count a step is a whole number."""

import types

import pytest
import torch

from windbench import harness, traffic

SEED = 2 ** 31 + 2727
READERS = ("gather_launches", "gather_host_ms")
NO_CELL = types.SimpleNamespace(scene_setup_s=0.0)

# two steps (us): the first with two gathers, the second with one; launches
# inside and outside them, a synchronise inside one, and the readback's
# launch outside every step
HOST = [("windbench.step", 0.0, 1000.0),
        ("fst.step", 10.0, 990.0),
        ("fst.advect", 100.0, 600.0),
        ("fst.gather", 110.0, 300.0),
        ("cudaLaunchKernel", 120.0, 130.0),
        ("cudaLaunchKernel", 140.0, 150.0),
        ("cudaStreamSynchronize", 200.0, 260.0),
        ("cudaLaunchKernel", 310.0, 320.0),
        ("fst.bounds", 350.0, 380.0),
        ("cudaLaunchKernel", 355.0, 360.0),
        ("fst.gather", 400.0, 500.0),
        ("cudaMemcpyAsync", 410.0, 420.0),
        ("cudaGetDevice", 430.0, 431.0),
        ("windbench.readback", 1000.0, 1200.0),
        ("cudaLaunchKernel", 1010.0, 1020.0),
        ("windbench.step", 2000.0, 2500.0),
        ("fst.step", 2010.0, 2490.0),
        ("fst.advect_density", 2100.0, 2400.0),
        ("fst.gather", 2110.0, 2300.0),
        ("cuLaunchKernel", 2120.0, 2130.0),
        ("cudaLaunchKernel", 2350.0, 2360.0)]


def _read(name, host=HOST):
    prof = dict(host=host, device=[], steps=2)
    return harness.reader(name).read(harness.Run(NO_CELL, {}, prof))


def test_launches_inside_the_gathers():
    # 120, 140 and 410 in the first step's gathers, 2120 in the second's;
    # 310, 355 and 2350 fall between gathers, 1010 in the readback
    assert _read("gather_launches") == 4 / 2


def test_host_time_inside_the_gathers_less_their_waits():
    own = (190.0 - 60.0) + 100.0 + 190.0
    assert _read("gather_host_ms") == pytest.approx(own / 1e3 / 2)


def test_nothing_to_read_without_the_gather_spans():
    # a split step, or a program that opens no fst.gather
    bare = [r for r in HOST if r[0] != "fst.gather"]
    no_steps = [r for r in HOST if r[0] != "fst.step"]
    for name in READERS:
        assert _read(name, host=bare) is None, name
        assert _read(name, host=no_steps) is None, name


def _compat_cell(device):
    cfg = dict(traffic.load_json("configs", "tunnel128_compat"), width=24,
               height=12, depth=10)
    wl = dict(traffic.load_json("workloads", "t128_compat_sphere"),
              scene={"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
              frame_steps=3)
    return harness.Cell("t128_compat_sphere", device, workload=wl,
                        config=cfg)


def _traced(cell, frames):
    harness.warm_up(cell, SEED, harness.Captures(cell.obstacles.shape,
                                                 cell.device))
    prof = harness.profile(cell, frames)
    run = harness.Run(cell, {}, prof)
    return {name: harness.reader(name).read(run)
            for name in READERS + ("step_launches",)}, prof


def test_traced_compat_run_on_the_cpu_reads_the_gathers():
    values, prof = _traced(_compat_cell(torch.device("cpu")), 2)
    assert [n for n, _, _ in prof["host"]].count("fst.gather") == 4 * 6
    # the plain path on the host launches nothing on a card
    assert values["gather_launches"] == 0
    assert values["gather_host_ms"] > 0


@pytest.mark.card
def test_traced_compat_gathers_launch_a_whole_number_a_step():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    values, _ = _traced(_compat_cell(torch.device("cuda", 0)), 2)
    n = values["gather_launches"]
    assert n == int(n) and 4 < n < values["step_launches"], values
    assert values["gather_host_ms"] > 0
