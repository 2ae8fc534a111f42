"""The per-layer readers on the CPU: the traced segment's entry spans count
each call of an entry point with its bytes and leave the program as it was,
and the host's own time leaves out the time blocked on the card."""

import types

import torch

from windbench import harness, traffic

SEED = 2 ** 31 + 99
NO_CELL = types.SimpleNamespace(scene_setup_s=0.0)


def _small_cell():
    cfg = dict(traffic.load_json("configs", "tunnel512_split"), width=12,
               height=8, depth=6)
    wl = dict(traffic.load_json("workloads", "t512_split_sphere"),
              scene={"kind": "sphere", "center": [4, 4, 3], "radius": 2},
              frame_steps=2)
    cell = harness.Cell("small", "cpu", workload=wl, config=cfg)
    cell.system.set_state(traffic.initial_state(
        cell.obstacles, wl["init"], SEED, cell.device))
    return cell


def test_entry_spans_count_each_call_and_restore_the_program():
    from fluid_simulation_tpu_torch.kernels import advect_split as mod
    from fluid_simulation_tpu_torch.models import windtunnel
    original = mod.advect_split
    name = "advect_split_roofline"
    readers = {name: harness.reader(name)}
    prof = harness.profile(_small_cell(), 2, readers)
    assert windtunnel.advect_split is original
    assert mod.advect_split is original
    count = readers[name].bytes_moved
    # a split step advects the velocity stack, then density: 2 frames of 2
    assert [(n, b) for n, _, b in prof["entries"]] == \
        [(name, count(6, 8, 12, 3)), (name, count(6, 8, 12, 1))] * 4
    # the CPU launches no kernel: no device time, so the reader reads nothing
    run = harness.Run(NO_CELL, {}, prof)
    assert run.entry(name)[1] == 0
    assert readers[name].read(run) is None
    assert run.entry("stream_solve_roofline") is None


def test_host_time_leaves_out_blocking_calls():
    host = [("windbench.step", 0.0, 1000.0),
            ("cudaLaunchKernel", 10.0, 20.0),
            ("cudaStreamSynchronize", 100.0, 700.0),
            ("windbench.step", 2000.0, 2500.0),
            ("cudaMemcpy", 2400.0, 2600.0),
            ("cudaStreamSynchronize", 3000.0, 3100.0)]
    run = harness.Run(NO_CELL, {}, dict(host=host, steps=2))
    own = (1000.0 - 600.0) + (500.0 - 100.0)
    assert harness.reader("host_ms_per_step").read(run) == own / 1e3 / 2


def test_device_time_goes_to_the_span_that_launched_it():
    spans = [(100.0, 200.0), (300.0, 400.0)]
    # runtime calls by correlation id: two in the first span, one in the
    # second, one outside any span; the ops run later, on the card's clock
    launches = {7: 110.0, 8: 190.0, 9: 350.0, 10: 250.0}
    ops = [(7, 500.0, 530.0), (8, 530.0, 580.0), (9, 600.0, 610.0),
           (10, 580.0, 600.0), (11, 610.0, 700.0)]
    assert harness.launched_us(spans, launches, ops) == [80.0, 10.0]


def test_profile_restores_the_program_when_a_step_raises():
    from fluid_simulation_tpu_torch.models import windtunnel
    original = windtunnel.advect_split
    cell = _small_cell()

    class Broken:
        def step(self):
            windtunnel.advect_split(torch.zeros(3, 8, 10, 14),
                                    *([torch.zeros(8, 10, 14)] * 3), 0.05)
            raise RuntimeError("broken")

    cell.system = Broken()
    readers = {"advect_split_roofline": harness.reader(
        "advect_split_roofline")}
    try:
        harness.profile(cell, 1, readers)
    except RuntimeError:
        pass
    assert windtunnel.advect_split is original
