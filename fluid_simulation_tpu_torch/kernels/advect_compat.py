"""Kernel 9: the trilinear gather of compat and fast advection
(``csrc/trilinear.cu``); its plain version is ``ops.advect.trilinear_gather``.

Port of ``fluid_simulation_tpu/kernels/advect_compat.py::corner_fetch``,
reached through ``trilinear_gather_pallas``: the 8 trilinear corners of the
padded ``prev`` at ``floor`` of the backtrace, then the lerp in the
reference's order. The JAX package takes it when ``SimParams.advect_window``
is above 0. Its window of z/y offsets answers the TPU's on-chip block sizes
only: the value never depends on it, since a backtrace that leaves the
window falls back to the exact gather. The card's kernel reads any address,
so it is exact for every backtrace and takes no window; it fetches the
corners and lerps them in one launch, which is what
``trilinear_gather_pallas`` returns.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.advect import trilinear_gather


def trilinear_gather_window(prev: torch.Tensor, xb: torch.Tensor,
                            yb: torch.Tensor,
                            zb: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of padded ``prev`` (D+2, H+2, W+2) at the
    interior-shaped (D, H, W) coordinates ``xb, yb, zb``; returns a new
    (D, H, W) tensor. A CPU tensor takes the plain version
    (``ops.advect.trilinear_gather``); a CUDA tensor launches the kernel or
    raises. The operands must be contiguous."""
    if not _build.on_card(prev):
        return trilinear_gather(prev, xb, yb, zb)
    if prev.ndim != 3 or min(prev.shape) < 3:
        raise ValueError(f"trilinear_gather: bad padded shape "
                         f"{tuple(prev.shape)}")
    interior = tuple(n - 2 for n in prev.shape)
    _build.check_operands("trilinear_gather", (prev, xb, yb, zb),
                          (None, interior, interior, interior))
    out = torch.empty_like(xb)
    _launch(prev, xb, yb, zb, out)
    LAUNCHES["trilinear_gather"] += 1
    return out


def _launch(prev, xb, yb, zb, out):
    D, H, W = out.shape
    ptr = _build.ptr
    _build.launch("fst_trilinear_gather", prev.get_device(), ptr(prev),
                  ptr(xb), ptr(yb), ptr(zb), ptr(out), D, H, W)
