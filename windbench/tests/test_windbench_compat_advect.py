"""``compat_advect_roofline``: its byte count against a hand count at a
small shape (D, H, W) = (3, 4, 5) (padded 5*6*7 = 210 cells, interior
3*4*5 = 60) and as the harness takes it from a call; a traced compat run on
the CPU at 24x12x10, which makes four entry calls a step; and a traced
split run, which makes none, so the reader reads nothing."""

import types

import pytest
import torch

from windbench import harness, traffic

SEED = 2 ** 31 + 2222
NAME = "compat_advect_roofline"
NO_CELL = types.SimpleNamespace(scene_setup_s=0.0)


@pytest.mark.parametrize("velocity, masked, cells", [
    (True, True, 210 + 2 * 60 + 60 + 210 + 210),
    (False, True, 210 + 3 * 60 + 60 + 210 + 210),
    (True, False, 210 + 2 * 60 + 210),
    (False, False, 210 + 3 * 60 + 210)])
def test_compat_advect_bytes(velocity, masked, cells):
    # prev padded in, the backtrace's other components' interiors in
    # (two for a velocity component, three for density), fluid_i and the
    # padded keep mask in (obstacle scenes), the padded result out
    assert harness.reader(NAME).bytes_moved(3, 4, 5, velocity, masked) \
        == 4 * cells


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_compat_advect_call_bytes(b, empty):
    """The count the harness takes from a call as the step makes it (every
    argument positional) and with ``empty_scene`` by keyword or left out."""
    mod = harness.reader(NAME)
    prev = torch.zeros(5, 6, 7)
    want = mod.bytes_moved(3, 4, 5, b != 0, not empty)
    head = (b, prev, prev, prev, prev, None, 0.05, "reference")
    assert mod.call_bytes("advect", head + (empty,), {}) == want
    assert mod.call_bytes("advect", head, {"empty_scene": empty}) == want
    if not empty:
        assert mod.call_bytes("advect", head, {}) == want


def _small(cell, config, frame_steps=1):
    """``cell``'s scene and configuration at 24x12x10 on the CPU."""
    cfg = dict(traffic.load_json("configs", config), width=24, height=12,
               depth=10)
    wl = dict(traffic.load_json("workloads", cell),
              scene={"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
              frame_steps=frame_steps)
    out = harness.Cell(cell, torch.device("cpu"), workload=wl, config=cfg)
    harness.warm_up(out, SEED, harness.Captures(out.obstacles.shape,
                                                out.device))
    return out


def test_traced_compat_run_makes_four_entry_calls_a_step():
    readers = {NAME: harness.reader(NAME)}
    prof = harness.profile(_small("t512_compat_sphere", "tunnel512_compat"),
                           3, readers)
    count = readers[NAME].bytes_moved
    velocity, density = count(10, 12, 24, True, True), \
        count(10, 12, 24, False, True)
    # three frames of one step: vx, vy, vz chained, then density
    assert [(n, b) for n, _, b in prof["entries"]] == \
        ([(NAME, velocity)] * 3 + [(NAME, density)]) * 3
    # the CPU launches no kernel: no device time, so the reader reads nothing
    run = harness.Run(NO_CELL, {}, prof)
    assert run.entry(NAME)[1] == 0
    assert readers[NAME].read(run) is None


def test_nothing_to_read_where_no_compat_advection_ran():
    readers = {NAME: harness.reader(NAME)}
    prof = harness.profile(_small("t512_split_sphere", "tunnel512_split"),
                           2, readers)
    assert prof["entries"] == []
    run = harness.Run(NO_CELL, {}, prof)
    assert run.entry(NAME) is None
    assert readers[NAME].read(run) is None
