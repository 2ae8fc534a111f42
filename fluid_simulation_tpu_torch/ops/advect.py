"""Semi-Lagrangian advection, backtrace + trilinear gather
(``fluid_simulation_tpu/ops/advect.py``).

Mirrors ``Simulation::advect`` (simulation.cpp:367-424):

- per-axis backtrace ``x_back = i - dt*W*vx`` (each axis scaled by its own
  dimension, simulation.cpp:384-386), clamped to ``[0.5, N+0.5]``;
- trilinear sample of ``prev`` in the reference's lerp order (x, then y,
  then z — simulation.cpp:412-420);
- for velocity component ``b`` the backtrace reads that component from
  ``prev`` and the other two from the current fields (simulation.cpp:380-382),
  so the three velocity advects chain (x, then y, then z);
- solid cells forced to zero, then ``setBounds(b)``.

The eight corners are read with one direct index gather per corner offset.
``advect`` and ``gather`` take the sampler as an argument: this module's
``trilinear_gather`` by default, or a wrapper of the same signature that
the step chooses (``kernels.advect_compat.trilinear_gather_window``), which
gives the same values.

Spans (``utils/profiling.span``): ``backtrace`` runs in
``fst.backtrace``, ``gather`` runs each sample in ``fst.gather``;
``advect`` runs its ``set_bounds`` in ``fst.bounds``. A compat step opens
four of each; a fast step two backtraces (the shared one of the velocity
and density's) and four gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.ops.bounds import set_bounds
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar
from fluid_simulation_tpu_torch.scene.masks import SceneMasks
from fluid_simulation_tpu_torch.utils.profiling import span


def _lerp8(c000, c100, c010, c110, c001, c101, c011, c111, sx, sy, sz):
    """Trilinear lerp from 8 corners in the reference's order (x, y, z)."""
    c00 = c000 * (1.0 - sx) + c100 * sx
    c01 = c001 * (1.0 - sx) + c101 * sx
    c10 = c010 * (1.0 - sx) + c110 * sx
    c11 = c011 * (1.0 - sx) + c111 * sx
    c0 = c00 * (1.0 - sy) + c10 * sy
    c1 = c01 * (1.0 - sy) + c11 * sy
    return c0 * (1.0 - sz) + c1 * sz


def trilinear_gather(prev: torch.Tensor, xb, yb, zb,
                     z_off: int = 0) -> torch.Tensor:
    """Trilinear sample of the padded field ``prev`` at backtraced
    coordinates (interior-shaped). Integer ``i`` is the centre of interior
    cell ``i``; with coordinates clamped as the reference does, every corner
    lies inside the padded array. ``z_off`` names the global z row that
    ``prev``'s row 0 holds (a sharded z window); the lerp fractions come
    from the global ``zb`` either way."""
    D2, H2, W2 = prev.shape
    i0 = torch.floor(xb).to(torch.int64)
    j0 = torch.floor(yb).to(torch.int64)
    k0 = torch.floor(zb).to(torch.int64)
    sx = xb - i0.to(xb.dtype)
    sy = yb - j0.to(yb.dtype)
    sz = zb - k0.to(zb.dtype)
    k0 = k0 - z_off

    flat = prev.reshape(-1)
    sy_, sz_ = W2, W2 * H2
    offsets = (0, 1, sy_, sy_ + 1, sz_, sz_ + 1, sz_ + sy_, sz_ + sy_ + 1)
    # clamp so that raw callers cannot index past the array; exact for
    # clamped coordinates, whose largest base is cell (D, H, W)
    base = (k0 * sz_ + j0 * sy_ + i0).clamp(0, flat.numel() - 1 - offsets[-1])
    corners = [flat[base + d] for d in offsets]
    return _lerp8(*corners, sx, sy, sz)


def gather(prev: torch.Tensor, xb, yb, zb,
           sample=trilinear_gather) -> torch.Tensor:
    """One trilinear sample of compat or fast advection, ``sample(prev,
    xb, yb, zb)``, in the span ``fst.gather``."""
    with span("fst.gather"):
        return sample(prev, xb, yb, zb)


def backtrace(vx_i, vy_i, vz_i, dt: float, W: int, H: int, D: int, dtype):
    """Backtraced coordinates of every interior cell, clamped like the
    reference (simulation.cpp:384-390), in the span ``fst.backtrace``."""
    with span("fst.backtrace"):
        dev = vx_i.device
        xi = torch.arange(1, W + 1, dtype=dtype, device=dev).reshape(1, 1, W)
        yi = torch.arange(1, H + 1, dtype=dtype, device=dev).reshape(1, H, 1)
        zi = torch.arange(1, D + 1, dtype=dtype, device=dev).reshape(D, 1, 1)
        dt = np.float32(dt)
        xb = xi - as_scalar(dt * np.float32(W), dtype) * vx_i
        yb = yi - as_scalar(dt * np.float32(H), dtype) * vy_i
        zb = zi - as_scalar(dt * np.float32(D), dtype) * vz_i
        lo = as_scalar(0.5, dtype)
        xb = xb.clamp(lo, as_scalar(np.float32(W) + np.float32(0.5), dtype))
        yb = yb.clamp(lo, as_scalar(np.float32(H) + np.float32(0.5), dtype))
        zb = zb.clamp(lo, as_scalar(np.float32(D) + np.float32(0.5), dtype))
        return xb, yb, zb


def advect(
    b: int,
    prev: torch.Tensor,
    vx: torch.Tensor,
    vy: torch.Tensor,
    vz: torch.Tensor,
    masks: SceneMasks,
    dt: float,
    wall_mode: str = "reference",
    empty_scene: bool = False,
    sample=trilinear_gather,
) -> torch.Tensor:
    """Advect ``prev`` through the velocity field; returns a new padded
    field. For ``b in (1, 2, 3)`` component ``b`` of the backtrace velocity
    is read from ``prev`` (simulation.cpp:380-382); pass the current
    vx/vy/vz. ``sample`` is the trilinear sampler (``gather``)."""
    D2, H2, W2 = prev.shape
    W, H, D = W2 - 2, H2 - 2, D2 - 2

    vx_i = (prev if b == 1 else vx)[1:-1, 1:-1, 1:-1]
    vy_i = (prev if b == 2 else vy)[1:-1, 1:-1, 1:-1]
    vz_i = (prev if b == 3 else vz)[1:-1, 1:-1, 1:-1]

    xb, yb, zb = backtrace(vx_i, vy_i, vz_i, dt, W, H, D, prev.dtype)
    sampled = gather(prev, xb, yb, zb, sample)
    new_i = sampled if empty_scene else sampled * masks.fluid_i
    out = torch.zeros_like(prev)
    out[1:-1, 1:-1, 1:-1] = new_i
    with span("fst.bounds"):
        return set_bounds(b, out, masks, wall_mode, empty_scene)
