"""Fast advection's velocity in one launch, kernel 20
(``csrc/advect_fast.cu``), beside its plain version.

The JAX package's fast step (``fluid_simulation_tpu/models/windtunnel.py:
339-355``) backtraces once through the projected velocity and samples each
of the three pre-diffusion saves there: XLA's backtrace, three XLA gathers
at window 0 or K9's corner fetch with a window, and ``jnp.stack``. The
kernel computes a cell's backtrace, corner base and fractions once, keeps
them in registers and lerps the eight corners of every save, so one launch
moves each operand once: the three velocity interiors, read in place from
the step's views of the padded fields, the three padded saves, and the
``(3, D, H, W)`` stack it writes. It computes the same for any window. The
step hands it to ``ops.advect.backtrace`` as ``fused`` on the card.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.advect import (
    backtrace, backtrace_scales, trilinear_gather)


def advect_fast_plain(vx_i: torch.Tensor, vy_i: torch.Tensor,
                      vz_i: torch.Tensor, prevs, dt: float) -> torch.Tensor:
    """The plain composition the kernel is held to: ``ops.advect.backtrace``
    of the velocity interiors, then ``trilinear_gather`` of each padded save
    in ``prevs`` there, stacked: a new ``(3, D, H, W)`` tensor."""
    D, H, W = vx_i.shape
    xb, yb, zb = backtrace(vx_i, vy_i, vz_i, dt, W, H, D, vx_i.dtype)
    return torch.stack([trilinear_gather(prev, xb, yb, zb)
                        for prev in prevs])


def _check_views(vel, shape, device: int) -> None:
    """Raise unless each velocity is a float32 (D, H, W) interior view of a
    contiguous padded field on the card ``device``: the kernel reads it in
    place with the padded strides."""
    D, H, W = shape
    strides = ((H + 2) * (W + 2), W + 2, 1)
    for i, t in enumerate(vel):
        if not _build.on_card(t) or t.get_device() != device:
            raise ValueError(f"advect_fast: velocity {i} on {t.device}, "
                             f"expected the card (cuda:{device})")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"advect_fast: {t.dtype} is not ported to the card yet "
                f"(ROADMAP A11); this kernel takes torch.float32")
        if t.shape != shape or t.stride() != strides:
            raise ValueError(
                f"advect_fast: velocity {i} has shape {tuple(t.shape)} and "
                f"strides {t.stride()}, expected {shape} with the padded "
                f"strides {strides}")


def advect_fast(vx_i: torch.Tensor, vy_i: torch.Tensor, vz_i: torch.Tensor,
                prevs, dt: float) -> torch.Tensor:
    """Fast advection's three velocity samples in one launch: the padded
    saves ``prevs`` (``pvx, pvy, pvz``) sampled along the backtrace through
    the velocity interiors ``vx_i, vy_i, vz_i``; a new ``(3, D, H, W)``
    tensor. A CPU tensor takes the plain version (``advect_fast_plain``); a
    CUDA tensor launches the kernel or raises. The saves must be contiguous
    padded fields, the velocities interior views of such fields
    (``vx[1:-1, 1:-1, 1:-1]``), read in place."""
    if not _build.on_card(vx_i):
        return advect_fast_plain(vx_i, vy_i, vz_i, prevs, dt)
    if len(prevs) != 3:
        raise ValueError(f"advect_fast: {len(prevs)} saves, expected 3")
    pad = prevs[0].shape
    if len(pad) != 3 or min(pad) < 3:
        raise ValueError(f"advect_fast: bad padded shape {tuple(pad)}")
    _build.check_operands("advect_fast", prevs, (pad,) * 3)
    D, H, W = (n - 2 for n in pad)
    _check_views((vx_i, vy_i, vz_i), (D, H, W), prevs[0].get_device())
    out = torch.empty((3, D, H, W), dtype=vx_i.dtype, device=vx_i.device)
    _launch(prevs, (vx_i, vy_i, vz_i), out, backtrace_scales(dt, W, H, D))
    LAUNCHES["advect_fast"] += 1
    return out


def _launch(prevs, vel, out, scales):
    _, D, H, W = out.shape
    ptr = _build.ptr
    _build.launch("fst_advect_fast", out.get_device(), *map(ptr, prevs),
                  *map(ptr, vel), ptr(out), D, H, W, *map(float, scales))
