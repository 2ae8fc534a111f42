"""Tests of the port that need the card (``card`` marker). Each skips, with
a reason, where no CUDA device is visible, and decides so inside the test.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_card.py -q --noconftest
"""

import pytest
import torch

from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls


@pytest.mark.card
@pytest.mark.parametrize("form", ls.MARCH_FORMS)
def test_march_form_fits_two_blocks_an_sm(form):
    """Every form of the pass kernel keeps two blocks on an SM, so that one
    block's barriers and plane loads overlap the other's work: exactly two
    at nsw 2, empty and keep (its shared memory fits no third), at least
    two for sweep 1 and the nsw 1 passes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    blocks = ls.march_blocks_per_sm(*form)
    if form[0] == 2:
        assert blocks == 2, (form, blocks)
    else:
        assert blocks >= 2, (form, blocks)


@pytest.mark.card
@pytest.mark.parametrize("dhw", [(1, 1, 1), (3, 5, 7), (5, 3, 130),
                                 (2, 3, 600), (8, 8, 16)])
@pytest.mark.parametrize("bs", [(0,), (2, 3), (1, 2, 3)])
@pytest.mark.parametrize("wall_mode", ["reference", "noslip"])
@pytest.mark.parametrize("masked", [False, True])
def test_pad_bounds_bitwise_to_plain(dhw, bs, wall_mode, masked):
    """The padding kernel (K4/K7) equals ``pad_bounds_plain`` bit for bit on
    ragged grids, one launch a call; the masks are interior views of
    padded masks, as the step passes them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fluid_simulation_tpu_torch.kernels import LAUNCHES
    from fluid_simulation_tpu_torch.kernels.bounds import (
        pad_bounds, pad_bounds_plain)
    D, H, W = dhw
    g = torch.Generator().manual_seed(D * 10007 + H * 101 + W + len(bs))
    smp = torch.randn((len(bs), D, H, W), generator=g)
    padded = [(torch.rand((D + 2, H + 2, W + 2), generator=g) < 0.7).float()
              for _ in range(2) if masked]
    interior = (slice(1, -1),) * 3
    want = pad_bounds_plain(smp, bs, wall_mode,
                            *(m[interior] for m in padded))
    name = "pad_bounds_masked" if masked else "pad_bounds"
    before = LAUNCHES[name]
    got = pad_bounds(smp.cuda(), bs, wall_mode,
                     *(m.cuda()[interior] for m in padded))
    assert LAUNCHES[name] == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
