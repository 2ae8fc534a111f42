"""Boundary conditions as face writes (``fluid_simulation_tpu/ops/bounds.py``).

Mirrors ``Simulation::setBounds`` (simulation.cpp:183-246):

1. x faces: x=0 mirrors x=1 (negated iff ``b==1``); x=W+1 is always an
   outflow copy of x=W (simulation.cpp:191).
2. y faces mirror, negated iff ``b==2``; 3. z faces, negated iff ``b==3``.
4. obstacles: one multiply by the precomputed keep mask, after the faces.

Only the interior rectangle of each ghost face is written; ghost edges and
corners keep whatever they held (zero for every field the step builds).
``wall_mode='noslip'`` negates every velocity component at the y/z walls.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.scene.masks import SceneMasks


def face_signs(b: int, wall_mode: str = "reference"):
    """(sx, sy, sz) ghost-face mirror signs of field tag ``b`` (0 scalar,
    1/2/3 velocity x/y/z); x+ is always a plain copy."""
    if b not in (0, 1, 2, 3):
        raise ValueError(f"b must be 0..3, got {b}")
    if wall_mode not in ("reference", "noslip"):
        raise ValueError(f"unknown wall_mode {wall_mode!r}")
    if wall_mode == "noslip" and b in (1, 2, 3):
        return (-1.0 if b == 1 else 1.0), -1.0, -1.0
    return ((-1.0 if b == 1 else 1.0), (-1.0 if b == 2 else 1.0),
            (-1.0 if b == 3 else 1.0))


def write_faces_(f: torch.Tensor, b: int, wall_mode: str = "reference"):
    """Write the six ghost faces of ``f`` in place, in setBounds' order.
    Callers pass only tensors they allocated themselves."""
    sx, sy, sz = face_signs(b, wall_mode)
    f[1:-1, 1:-1, 0] = sx * f[1:-1, 1:-1, 1]
    f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
    f[1:-1, 0, 1:-1] = sy * f[1:-1, 1, 1:-1]
    f[1:-1, -1, 1:-1] = sy * f[1:-1, -2, 1:-1]
    f[0, 1:-1, 1:-1] = sz * f[1, 1:-1, 1:-1]
    f[-1, 1:-1, 1:-1] = sz * f[-2, 1:-1, 1:-1]
    return f


def set_bounds(b: int, f: torch.Tensor, masks: SceneMasks,
               wall_mode: str = "reference",
               empty_scene: bool = False) -> torch.Tensor:
    """Apply boundary + obstacle conditions to a padded field; returns a new
    tensor (``f`` is left unchanged)."""
    out = write_faces_(f.clone(), b, wall_mode)
    if empty_scene:
        return out
    keep = masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar
    return out * keep
