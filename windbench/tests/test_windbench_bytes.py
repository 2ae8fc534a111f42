"""The byte counts of the three roofline metrics, against a hand count at
a small shape (D, H, W) = (3, 4, 5): padded 5*6*7 = 210 cells, interior
3*4*5 = 60."""

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("keep, cells", [(False, 210 + 60 + 210),
                                         (True, 210 + 60 + 60 + 210)])
def test_stream_solve_bytes(keep, cells):
    # padded field in, interior rhs (and keep) in, padded field out
    assert _metric("stream_solve_roofline").bytes_moved(3, 4, 5, keep) \
        == 4 * cells


@pytest.mark.parametrize("masked, cells", [
    (False, 3 * 4 * 7 + 3 * 6 * 5 + 5 * 4 * 5 + 3 * 60),
    (True, 3 * 4 * 7 + 3 * 6 * 5 + 5 * 4 * 5 + 60 + 3 * 60)])
def test_stream_project_bytes(masked, cells):
    # vx with its x ghosts, vy with its y ghosts, vz with its z ghosts, the
    # fluid mask, three interiors out
    assert _metric("stream_project_roofline").bytes_moved(3, 4, 5, masked) \
        == 4 * cells


def test_advect_split_bytes():
    # three padded fields, vx on (D+2, H+2, W), vy on (D+2, H, W), vz on
    # the interior, three interiors out
    cells = 3 * 210 + 5 * 6 * 5 + 5 * 4 * 5 + 60 + 3 * 60
    assert _metric("advect_split_roofline").bytes_moved(3, 4, 5) == 4 * cells
