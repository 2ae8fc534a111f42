"""keep_form_share reads the program's own count of the keep passes'
blocks by form, and only in the cells whose step runs keep passes."""

import json
import sys
import types
from pathlib import Path

import pytest

from windbench import harness

SPEC = json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
SPHERES = ["t512_split_sphere", "t512_compat_sphere", "t512_fast_sphere",
           "t512_noslip_vort_sphere"]
METRIC = "keep_form_share"


def _with_counter(monkeypatch, **module):
    reader = harness.reader(METRIC)
    monkeypatch.setitem(sys.modules, reader.KERNELS,
                        types.SimpleNamespace(**module))
    return reader


def test_keep_form_share_is_the_streamed_solves_in_the_sphere_cells():
    """A share of the streamed solve's layer, lower better, moving
    ``step_ms``, listed for the four t512 sphere cells and no other (the
    empty tunnel and the resident route run no keep pass)."""
    m, = [m for m in SPEC["per_layer"] if m["name"] == METRIC]
    solve, = [s for s in SPEC["per_layer"]
              if s["name"] == "stream_solve_roofline"]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "lower", "program_span", "step_ms")
    assert m["layer"] == solve["layer"]
    assert m["workloads"] == SPHERES
    for w in SPEC["workloads"]:
        layers = harness.cell_metrics(SPEC, w["name"])[1]
        assert (METRIC in layers) == (w["name"] in SPHERES), w["name"]
    assert "Predicted" in harness.reader(METRIC).__doc__


@pytest.mark.parametrize("module", [
    {}, {"MARCH_BLOCKS": {}},
    {"MARCH_BLOCKS": {"keep_form": 0, "keep_free": 0}}])
def test_keep_form_share_reads_nothing_without_keep_passes(monkeypatch,
                                                            module):
    """No counter (a program before it), or no keep pass counted: no
    value, and no error."""
    assert _with_counter(monkeypatch, **module).read(None) is None


def test_keep_form_share_reads_nothing_without_the_program(monkeypatch):
    reader = harness.reader(METRIC)
    monkeypatch.delitem(sys.modules, reader.KERNELS, raising=False)
    assert reader.read(None) is None


def test_keep_form_share_reads_the_share_of_keep_form_blocks(monkeypatch):
    """100 x keep_form / (keep_form + keep_free), from the counter as the
    program leaves it: a step of the bench sphere's 37 keep passes."""
    reader = _with_counter(monkeypatch, MARCH_BLOCKS={
        "keep_form": 1457, "keep_free": 39936 - 1457})
    assert reader.read(None) == pytest.approx(100 * 1457 / 39936)
    reader = _with_counter(monkeypatch, MARCH_BLOCKS={
        "keep_form": 3, "keep_free": 0})
    assert reader.read(None) == 100.0
