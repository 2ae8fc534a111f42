"""The port's profiling helpers on the CPU: the busy-time arithmetic, and the
refusal to report a device metric without a card."""

import pytest
import torch

from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.utils.profiling import (
    busy_us, cells, step_breakdown)

torch.set_num_threads(1)


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
    wt = WindTunnel(SimParams(width=8, height=4, depth=4, acc=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        step_breakdown(wt, steps=1, warmup=0)


def test_cells_are_the_slice_on_the_kernel_path():
    c = cells()
    assert list(c) == ["split 128x64x64", "compat 128x64x64",
                       "split 256x128x128"]
    assert all(p.use_pallas and p.solver == "rbgs" and p.dtype == "float32"
               and not p.vorticity for p in c.values())
    assert c["compat 128x64x64"] == SimParams(div_stats=False,
                                              step_stats=False)
