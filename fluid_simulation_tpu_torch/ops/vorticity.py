"""Vorticity confinement (Fedkiw, Stam & Jensen 2001)
(``fluid_simulation_tpu/ops/vorticity.py``).

The force ``f = eps * dt * (N x omega)`` re-injects the small swirls that
semi-Lagrangian advection smears. Central differences on the interior, zero
in and next to solids. Plain torch; ``kernels/vorticity.py`` holds the
card's kernel, which repeats this arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.ops.linsolve import as_scalar
from fluid_simulation_tpu_torch.scene.masks import SceneMasks


def _central(f, axis):
    """Central difference of a padded field over the interior (unit spacing)."""
    if axis == 0:   # z
        return 0.5 * (f[2:, 1:-1, 1:-1] - f[:-2, 1:-1, 1:-1])
    if axis == 1:   # y
        return 0.5 * (f[1:-1, 2:, 1:-1] - f[1:-1, :-2, 1:-1])
    return 0.5 * (f[1:-1, 1:-1, 2:] - f[1:-1, 1:-1, :-2])  # x


def force(vx, vy, vz, keep_i, eps: float, dt: float):
    """Return (fx, fy, fz) interior force fields scaled by dt, with the
    interior keep mask ``keep_i`` (no-slip ring and solids 0)."""
    wx_i = _central(vz, 1) - _central(vy, 0)
    wy_i = _central(vx, 0) - _central(vz, 2)
    wz_i = _central(vy, 2) - _central(vx, 1)

    mag = torch.zeros_like(vx)
    mag[1:-1, 1:-1, 1:-1] = torch.sqrt(wx_i * wx_i + wy_i * wy_i
                                       + wz_i * wz_i)
    gx, gy, gz = _central(mag, 2), _central(mag, 1), _central(mag, 0)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + as_scalar(1e-5, vx.dtype)
    nx, ny, nz = gx / norm, gy / norm, gz / norm

    s = as_scalar(np.float32(eps) * np.float32(dt), vx.dtype) * keep_i
    return (s * (ny * wz_i - nz * wy_i), s * (nz * wx_i - nx * wz_i),
            s * (nx * wy_i - ny * wx_i))


def add_force(vel, forces):
    """New padded fields: each of ``vel`` with its force added to the
    interior."""
    outs = []
    for v, f in zip(vel, forces):
        v = v.clone()
        v[1:-1, 1:-1, 1:-1] += f
        outs.append(v)
    return tuple(outs)


def apply_confinement(vx, vy, vz, masks: SceneMasks, eps: float, dt: float):
    """New (vx, vy, vz) with the confinement force added to the interior."""
    if eps == 0.0:
        return vx, vy, vz
    return add_force((vx, vy, vz), force(vx, vy, vz,
                                         masks.keep_vel[1:-1, 1:-1, 1:-1],
                                         eps, dt))
