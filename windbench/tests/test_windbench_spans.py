"""The readers of the program's own spans (``fst.*``, opened inside
``simulation_step`` and ``WindTunnel.__init__``): on synthetic rows, where
nested spans, blocking calls, and launches and gaps outside the step show;
in a traced run on the CPU at 24x12x10; and on the card, where no span may
leave a row on the device."""

import types

import pytest
import torch

from windbench import harness, run, traffic

SEED = 2 ** 31 + 1515
READERS = ("step_host_ms", "step_launches", "step_syncs", "step_idle_ms",
           "tunnel_setup_s")
NO_CELL = types.SimpleNamespace(scene_setup_s=0.0)

# two traced frames of one step each: the benchmark's spans around the
# program's, a readback after each step (us)
HOST = [("windbench.step", 0.0, 1000.0),
        ("fst.step", 10.0, 990.0),
        ("fst.project", 100.0, 500.0),
        ("fst.bounds", 300.0, 400.0),
        ("cudaLaunchKernel", 150.0, 160.0),
        ("cudaLaunchKernelExC", 310.0, 320.0),
        ("cudaMemcpyAsync", 600.0, 610.0),
        ("cudaStreamSynchronize", 620.0, 900.0),
        ("cudaGetDevice", 950.0, 951.0),
        ("windbench.readback", 1000.0, 1200.0),
        ("cudaLaunchKernel", 1010.0, 1020.0),
        ("cudaMemcpy", 1030.0, 1190.0),
        ("windbench.step", 2000.0, 2500.0),
        ("fst.step", 2010.0, 2490.0),
        ("cuLaunchKernel", 2100.0, 2110.0),
        ("cudaEventSynchronize", 2400.0, 2450.0),
        ("windbench.readback", 2500.0, 2600.0)]
DEVICE = [("k1", 200.0, 300.0), ("k2", 350.0, 400.0),
          ("copy", 1100.0, 1150.0), ("k3", 2200.0, 2300.0),
          ("k4", 2250.0, 2330.0), ("k5", 2350.0, 2400.0)]


def _read(name, cell=NO_CELL, host=HOST, device=DEVICE):
    prof = dict(host=host, device=device, steps=2)
    return harness.reader(name).read(harness.Run(cell, {}, prof))


def test_host_time_inside_the_steps_less_their_waits():
    own = (980.0 - 280.0) + (480.0 - 50.0)
    assert _read("step_host_ms") == pytest.approx(own / 1e3 / 2)


def test_launches_and_syncs_inside_the_steps():
    # the readback's launch and synchronous copy fall outside the steps
    assert _read("step_launches") == 4 / 2
    assert _read("step_syncs") == 2 / 2


def test_idle_gaps_that_begin_inside_a_step():
    # 300-350 and 400-1100 begin in the first step, 2330-2350 in the
    # second; 1150-2200 begins in the readback; k4 overlaps k3
    idle = 50.0 + 700.0 + 20.0
    assert _read("step_idle_ms") == pytest.approx(idle / 1e3 / 2)
    assert _read("step_idle_ms", device=[]) is None


def test_nothing_to_read_without_the_program_spans():
    bare = [r for r in HOST if not r[0].startswith("fst.")]
    for name in READERS:
        assert _read(name, host=bare) is None, name
    # the low-precision control has no tunnel; an older tunnel no setup_s
    control = types.SimpleNamespace(scene_setup_s=0.0, system=object())
    older = types.SimpleNamespace(scene_setup_s=0.0,
                                  system=types.SimpleNamespace(wt=object()))
    assert _read("tunnel_setup_s", cell=control) is None
    assert _read("tunnel_setup_s", cell=older) is None
    tunnel = types.SimpleNamespace(setup_s={"fst.setup": 0.5})
    port = types.SimpleNamespace(scene_setup_s=0.0,
                                 system=types.SimpleNamespace(wt=tunnel))
    assert _read("tunnel_setup_s", cell=port) == 0.5


def test_traced_run_on_the_cpu_reads_the_program_spans():
    cfg = dict(traffic.load_json("configs", "tunnel512_split"), width=24,
               height=12, depth=10)
    wl = dict(traffic.load_json("workloads", "t512_split_sphere"),
              scene={"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
              frame_steps=3)
    result, lines = run.execute(harness.benchmark(), "t512_split_sphere",
                                SEED, 0.6, True, torch.device("cpu"),
                                workload=wl, config=cfg)
    assert result["correct"], lines
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["tunnel_setup_s"] > 0
    assert metrics["step_host_ms"] > 0
    # the plain path on the host waits on and launches nothing on a card
    assert metrics["step_syncs"] == 0 and metrics["step_launches"] == 0
    assert "step_idle_ms" not in metrics
    # the benchmark's step span holds the program's
    assert metrics["step_host_ms"] <= metrics["host_ms_per_step"]


@pytest.mark.card
def test_traced_t512_step_leaves_no_span_on_the_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = harness.Cell("t512_split_sphere", torch.device("cuda", 0))
    harness.warm_up(cell, SEED, harness.Captures(cell.obstacles.shape,
                                                 cell.device))
    prof = harness.profile(cell, 3)
    assert [n for n, _, _ in prof["host"]].count("fst.step") == 3
    assert not [n for n, _, _ in prof["device"] if n.startswith("fst.")]
    r = harness.Run(cell, {}, prof)
    ops = harness.reader("device_ops_per_step").read(r)
    launches = harness.reader("step_launches").read(r)
    assert 0 <= ops - launches <= 3, (ops, launches)
