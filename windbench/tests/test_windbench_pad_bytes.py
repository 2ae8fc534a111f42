"""The byte count of ``pad_bounds_roofline`` against a hand count at a
small shape (D, H, W) = (3, 4, 5): padded 5*6*7 = 210 cells, interior
3*4*5 = 60."""

import importlib.util
from pathlib import Path

import pytest

METRIC = Path(__file__).resolve().parents[1] / "metrics" / \
    "pad_bounds_roofline.py"


def _metric():
    spec = importlib.util.spec_from_file_location("pad_bounds_roofline",
                                                  METRIC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fields, masked, cells", [
    (3, False, 3 * 60 + 3 * 210),
    (1, True, 60 + 2 * 60 + 210)])
def test_pad_bounds_bytes(fields, masked, cells):
    # the interiors in, the fluid and keep masks in once for all fields,
    # the padded fields out
    assert _metric().bytes_moved(3, 4, 5, fields, masked) == 4 * cells


@pytest.mark.parametrize("masked", [False, True])
def test_pad_bounds_call_bytes(masked):
    """The count the harness takes from a call as the step makes it: a
    stack or one field, the masks by keyword."""
    import torch
    mod = _metric()
    kw = dict(fluid_i=torch.ones(3, 4, 5), keep_i=torch.ones(3, 4, 5)) \
        if masked else {}
    for smp, fields in ((torch.zeros(3, 3, 4, 5), 3),
                        (torch.zeros(3, 4, 5), 1)):
        assert mod.call_bytes("pad_bounds", (smp, (1, 2, 3)[:fields],
                                             "reference"), kw) \
            == mod.bytes_moved(3, 4, 5, fields, masked)
