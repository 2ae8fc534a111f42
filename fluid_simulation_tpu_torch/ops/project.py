"""Pressure projection with obstacle-aware stencils
(``fluid_simulation_tpu/ops/project.py``).

Mirrors ``Simulation::project`` (simulation.cpp:289-362):

1. ``h = 1/cbrt(W*H*D)`` (simulation.cpp:295).
2. Divergence: central differences that skip neighbours which are solid or
   outside the interior; ``div = -0.5*h*sum``; zero inside solids; ``p = 0``.
3. Poisson solve with the linear solver, ``a=1, c=6`` (simulation.cpp:318-320).
4. Gradient subtraction: central ``/2h`` where both neighbours are valid
   fluid, one-sided ``/h`` where one is, zero otherwise; then setBounds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fluid_simulation_tpu_torch.ops.bounds import set_bounds
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar, linear_solver
from fluid_simulation_tpu_torch.scene.masks import SceneMasks


def grid_h(width: int, height: int, depth: int) -> float:
    """Mesh spacing ``1/cbrt(W*H*D)`` in f32 (simulation.cpp:295)."""
    return float(np.float32(1.0) / np.cbrt(np.float32(width * height * depth)))


def divergence(vx, vy, vz, masks: SceneMasks, h: float,
               empty_scene: bool = False) -> torch.Tensor:
    """Obstacle-aware divergence as a padded field (zero ghost shell, zero in
    solids), as simulation.cpp:297-316 leaves it before its setBounds."""
    hh = as_scalar(np.float32(-0.5) * np.float32(h), vx.dtype)
    div_val = (
        vx[1:-1, 1:-1, 2:] * masks.nb_xp - vx[1:-1, 1:-1, :-2] * masks.nb_xm
        + vy[1:-1, 2:, 1:-1] * masks.nb_yp - vy[1:-1, :-2, 1:-1] * masks.nb_ym
        + vz[2:, 1:-1, 1:-1] * masks.nb_zp - vz[:-2, 1:-1, 1:-1] * masks.nb_zm
    )
    div_i = hh * div_val if empty_scene else hh * div_val * masks.fluid_i
    out = torch.zeros_like(vx)
    out[1:-1, 1:-1, 1:-1] = div_i
    return out


def _one_axis_gradient(p, mask_p, mask_m, shift_p, shift_m, h, dtype):
    """Branch-free central/one-sided/zero gradient selection
    (simulation.cpp:329-335 and analogues)."""
    inv_h = as_scalar(np.float32(1.0) / np.float32(h), dtype)
    inv_2h = as_scalar(np.float32(1.0) / (np.float32(2.0) * np.float32(h)),
                       dtype)
    p_i = p[1:-1, 1:-1, 1:-1]
    p_p = shift_p(p)
    p_m = shift_m(p)
    both = mask_p * mask_m
    central = (p_p - p_m) * inv_2h
    fwd = (p_p - p_i) * inv_h
    bwd = (p_i - p_m) * inv_h
    return both * central + (mask_p - both) * fwd + (mask_m - both) * bwd


def project(
    vx: torch.Tensor,
    vy: torch.Tensor,
    vz: torch.Tensor,
    masks: SceneMasks,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Make the velocity field (approximately) divergence-free. Returns
    ``(vx, vy, vz, pressure, divergence)``, all new tensors."""
    dtype = vx.dtype
    D2, H2, W2 = vx.shape
    h = grid_h(W2 - 2, H2 - 2, D2 - 2)

    div = divergence(vx, vy, vz, masks, h, empty_scene)
    div = set_bounds(0, div, masks, wall_mode, empty_scene)
    p = set_bounds(0, torch.zeros_like(vx), masks, wall_mode, empty_scene)
    p = linear_solver(0, p, div, 1.0, 6.0, masks, acc=acc, solver=solver,
                      wall_mode=wall_mode, use_pallas=use_pallas,
                      empty_scene=empty_scene)

    grad_x = _one_axis_gradient(
        p, masks.nb_xp, masks.nb_xm,
        lambda q: q[1:-1, 1:-1, 2:], lambda q: q[1:-1, 1:-1, :-2], h, dtype)
    grad_y = _one_axis_gradient(
        p, masks.nb_yp, masks.nb_ym,
        lambda q: q[1:-1, 2:, 1:-1], lambda q: q[1:-1, :-2, 1:-1], h, dtype)
    grad_z = _one_axis_gradient(
        p, masks.nb_zp, masks.nb_zm,
        lambda q: q[2:, 1:-1, 1:-1], lambda q: q[:-2, 1:-1, 1:-1], h, dtype)

    outs = []
    for v, g in ((vx, grad_x), (vy, grad_y), (vz, grad_z)):
        v = v.clone()
        # solid cells are skipped by the reference (simulation.cpp:326)
        v[1:-1, 1:-1, 1:-1] += -g if empty_scene else -g * masks.fluid_i
        outs.append(v)
    vx, vy, vz = (set_bounds(b, v, masks, wall_mode, empty_scene)
                  for b, v in zip((1, 2, 3), outs))
    return vx, vy, vz, p, div
