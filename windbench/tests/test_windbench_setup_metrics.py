"""The set-up metrics read the program's own records and are reported in
every cell, as ``setup_s`` is."""

import json
from pathlib import Path

import pytest

from windbench import harness

SPEC = json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
SETUP_METRICS = ("context_setup_s", "library_load_s", "first_launch_s",
                 "first_step_s")


@pytest.mark.parametrize("name", SETUP_METRICS)
def test_setup_metrics_read_the_program_in_every_cell(name):
    """The set-up metrics read the program's own records, move
    ``setup_s``, and have no ``workloads``: every cell reports them, as
    every cell reports ``setup_s``."""
    m, = [m for m in SPEC["per_layer"] if m["name"] == name]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "s", "lower", "program_span", "setup_s")
    assert "workloads" not in m
    for w in SPEC["workloads"]:
        assert name in harness.cell_metrics(SPEC, w["name"])[1]
    assert "Predicted" in harness.reader(name).__doc__
