"""A short run of every cell on the card: correct, with its end-to-end
metrics. Needs a CUDA device (``card`` marker); skips without one."""

import pytest
import torch

from windbench import harness, run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    result, lines = run.execute(harness.benchmark(), cell, 2 ** 31 + 7, 2.0,
                                False, torch.device("cuda", 0))
    assert result["correct"], lines
    assert result["metrics"]["setup_s"]["value"] > 0
