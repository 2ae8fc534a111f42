"""Compat advection's kernels: kernel 9, the trilinear gather
(``csrc/trilinear.cu``), and kernel 19, a whole compat advect in one
launch (``csrc/advect_compat.cu``), each beside its plain version.

Kernel 9 ports ``fluid_simulation_tpu/kernels/advect_compat.py::corner_fetch``,
reached through ``trilinear_gather_pallas``: the 8 trilinear corners of the
padded ``prev`` at ``floor`` of the backtrace, then the lerp in the
reference's order. The JAX package takes it when ``SimParams.advect_window``
is above 0. Its window of z/y offsets answers the TPU's on-chip block sizes
only: the value never depends on it, since a backtrace that leaves the
window falls back to the exact gather. The card's kernel reads any address,
so it is exact for every backtrace and takes no window; it fetches the
corners and lerps them in one launch, which is what
``trilinear_gather_pallas`` returns. No route of the step takes it: fast's
velocity samples, which the JAX package takes through it with a window,
are kernel 20 (``kernels/advect_fast.py``) at any window.

Kernel 19 fuses one ``ops.advect.advect`` call: the JAX package's XLA
backtrace, the corner fetch and lerp, the solid mask and XLA's setBounds
with its keep multiply. Every separate op of the plain call streams a whole
field, about ninety of them; the kernel reads each operand once and writes
the padded result once, so it is bound by those bytes (``csrc/
advect_compat.cu`` gives the design). The step hands it to every
``advect`` call it makes on the card: compat's four a step, fast's density.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.advect import (
    advect, backtrace_scales, trilinear_gather)
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.scene.masks import SceneMasks


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


def advect_compat_plain(b: int, prev: torch.Tensor, vx: torch.Tensor,
                        vy: torch.Tensor, vz: torch.Tensor,
                        masks: SceneMasks, dt: float,
                        wall_mode: str = "reference",
                        empty_scene: bool = False) -> torch.Tensor:
    """The plain call the kernel is held to: ``ops.advect.advect`` with
    the plain gather (the backtrace, the trilinear gather, times
    ``fluid_i``, embedded in zeros, then ``set_bounds``)."""
    return advect(b, prev, vx, vy, vz, masks, dt, wall_mode, empty_scene)


def advect_compat(b: int, prev: torch.Tensor, vx: torch.Tensor,
                  vy: torch.Tensor, vz: torch.Tensor, masks: SceneMasks,
                  dt: float, wall_mode: str = "reference",
                  empty_scene: bool = False) -> torch.Tensor:
    """``ops.advect.advect(b, prev, vx, vy, vz, masks, dt, wall_mode,
    empty_scene)`` in one launch: a new padded field. For ``b`` 1-3 the
    backtrace takes component ``b`` from ``prev``, the others from the
    current padded ``vx, vy, vz``; for density (0) all three. Obstacle
    scenes read ``masks.fluid_i`` and the keep mask of ``b``; an empty
    scene reads no mask. A CPU tensor takes the plain version
    (``advect_compat_plain``); a CUDA tensor launches the kernel or raises.
    The fields must be contiguous."""
    if not _build.on_card(prev):
        return advect_compat_plain(b, prev, vx, vy, vz, masks, dt,
                                   wall_mode, empty_scene)
    signs = face_signs(b, wall_mode)
    if prev.ndim != 3 or min(prev.shape) < 3:
        raise ValueError(f"advect_compat: bad padded shape "
                         f"{tuple(prev.shape)}")
    vel = tuple(prev if b == axis else f
                for axis, f in ((1, vx), (2, vy), (3, vz)))
    _build.check_operands("advect_compat", (prev, *vel), (prev.shape,) * 4)
    D, H, W = (n - 2 for n in prev.shape)
    fluid_i = keep = None
    if not empty_scene:
        fluid_i = masks.fluid_i
        keep = masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar
        _build.check_operands("advect_compat", (prev, fluid_i, keep),
                              (None, (D, H, W), prev.shape))
    out = torch.empty_like(prev)
    _launch_advect(prev, *vel, fluid_i, keep, out,
                   backtrace_scales(dt, W, H, D), _build.neg_mask([signs]))
    LAUNCHES["advect_compat"] += 1
    return out


def _launch_advect(prev, u, v, w, fluid_i, keep, out, scales, neg_mask):
    D, H, W = (n - 2 for n in prev.shape)
    ptr = _build.ptr
    masks = (None, None) if fluid_i is None else (ptr(fluid_i), ptr(keep))
    _build.launch("fst_advect_compat", prev.get_device(), ptr(prev), ptr(u),
                  ptr(v), ptr(w), *masks, ptr(out), D, H, W,
                  *map(float, scales), neg_mask)
