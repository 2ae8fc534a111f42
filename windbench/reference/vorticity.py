"""The benchmark's plain split step with vorticity confinement, in plain
PyTorch, for the configurations whose ``reference`` is ``vorticity``.

It is ``step.py``'s split step (inlets, three velocity diffusions,
projection, split advection of the pre-diffusion velocities, projection,
density advection, stats) with vorticity confinement between the padded
velocity advection and the second projection, as the project's third
published deployment runs it (rbgs projection, vorticity confinement,
no-slip walls). The confinement follows Fedkiw, Stam & Jensen, "Visual
Simulation of Smoke" (SIGGRAPH 2001), section 4:

  curl           w = curl u on the interior, each derivative the central
                 difference 0.5 (a - b) over unit cells:
                 wx = dy(uz) - dz(uy), wy = dz(ux) - dx(uz),
                 wz = dx(uy) - dy(ux);
  magnitude      |w| = sqrt((wx wx + wy wy) + wz wz) on the interior of a
                 padded field whose ghost shell is zero;
  direction      g = grad |w| by the same central differences (the zero
                 shell read at the faces), N = g / (|g| + 1e-5);
  force          u += s (N x w) on the interior, s = f32(eps) f32(dt)
                 keep_vel: zero in solids and next to them; the ghost
                 faces are left as they were (the projection after it
                 writes them).

Walls. ``step.signs`` refuses ``wall_mode`` "noslip" for a scalar field (b
= 0: density, divergence, pressure), whose faces are a plain mirror under
both wall modes; so this module restates ``step.project`` (``project``
below, the same operations) with the divergence and pressure faces written
as the reference walls write them, pads density the same way, and passes
the configuration's ``wall_mode`` to every velocity field (b = 1-3), whose
y and z faces no-slip walls negate.

Departure from the paper, which the configuration states: the force is
eps (N x w) with eps in grid units, where the paper writes eps h (N x w)
with the mesh spacing h. The order of every operation above is the port's
(``fluid_simulation_tpu_torch``'s plain confinement and its kernel), so
that a float32 run of either equals this one bit for bit.

Every field is (D + 2, H + 2, W + 2), z-major, in the dtype of the state it
is given (float32, or bfloat16 for the benchmark's low-precision control);
the scalars are rounded to float32 and then to that dtype. It keeps the
contract in ``step.py``'s docstring and imports numpy, torch and
``step.py`` only: nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .step import (F32, Masks, advect, divergence, faces_, grid_h, padded,
                   relax, rounded)
from .step import build_masks  # noqa: F401  (the contract's masks)


class Params(NamedTuple):
    """``step.Params``'s physics and the confinement strength."""

    width: int
    height: int
    depth: int
    dt: float
    diff: float
    acc: int
    speed: float
    inlet_density: float
    wall_mode: str
    vorticity: float


def params_of(config: dict) -> Params:
    """The reference's parameters from a configuration file's fields; it
    computes split mode with rbgs, ``diff`` for velocity and vorticity
    confinement of a positive strength, and refuses any other
    configuration."""
    if ((config["mode"], config["solver"], config["use_visc_for_velocity"])
            != ("split", "rbgs", False) or not config["vorticity"] > 0):
        raise NotImplementedError("the vorticity reference computes split "
                                  "mode with rbgs, diff and vorticity > 0 "
                                  "only")
    return Params(*(config[k] for k in Params._fields))


# the walls of a scalar field (b = 0): one mirror under both wall modes
SCALAR_WALLS = "reference"


def project(vx, vy, vz, m: Masks, p: Params):
    """``step.project`` with the divergence and pressure faces mirrored as
    ``SCALAR_WALLS`` and the velocity faces as ``p.wall_mode``; new
    fields."""
    h = grid_h(p)
    div = torch.zeros_like(vx)
    div[1:-1, 1:-1, 1:-1] = divergence(vx, vy, vz, m, h)
    div = faces_(div, 0, SCALAR_WALLS) * m.keep_scalar
    pr = relax(0, torch.zeros_like(vx), div, 1.0, 6.0, m.keep_scalar, m.red,
               p.acc, SCALAR_WALLS)
    inv_h = rounded(F32(1.0) / h, vx.dtype)
    inv_2h = rounded(F32(1.0) / (F32(2.0) * h), vx.dtype)
    pi = pr[1:-1, 1:-1, 1:-1]
    shifted = ((pr[1:-1, 1:-1, 2:], pr[1:-1, 1:-1, :-2]),
               (pr[1:-1, 2:, 1:-1], pr[1:-1, :-2, 1:-1]),
               (pr[2:, 1:-1, 1:-1], pr[:-2, 1:-1, 1:-1]))
    out = []
    for axis, (b, v) in enumerate(((1, vx), (2, vy), (3, vz))):
        pp, pm = shifted[axis]
        mp, mm = m.nb[2 * axis], m.nb[2 * axis + 1]
        both = mp * mm
        g = (both * ((pp - pm) * inv_2h) + (mp - both) * ((pp - pi) * inv_h)
             + (mm - both) * ((pi - pm) * inv_h))
        v = v.clone()
        v[1:-1, 1:-1, 1:-1] += -g * m.fluid
        out.append(faces_(v, b, p.wall_mode) * m.keep_vel)
    return tuple(out)


def _d(f, axis):
    """The central difference 0.5 (a - b) of padded ``f`` along ``axis``
    (0 z, 1 y, 2 x) on the interior."""
    hi = [slice(1, -1)] * 3
    lo = [slice(1, -1)] * 3
    hi[axis], lo[axis] = slice(2, None), slice(None, -2)
    return 0.5 * (f[tuple(hi)] - f[tuple(lo)])


def confine(vx, vy, vz, keep_vel, p: Params):
    """New padded (vx, vy, vz): the confinement force added to the
    interior, the ghost faces as they were."""
    X, Y, Z = 2, 1, 0
    wx = _d(vz, Y) - _d(vy, Z)
    wy = _d(vx, Z) - _d(vz, X)
    wz = _d(vy, X) - _d(vx, Y)
    mag = torch.zeros_like(vx)
    mag[1:-1, 1:-1, 1:-1] = torch.sqrt(wx * wx + wy * wy + wz * wz)
    gx, gy, gz = _d(mag, X), _d(mag, Y), _d(mag, Z)
    norm = (torch.sqrt(gx * gx + gy * gy + gz * gz)
            + rounded(1e-5, vx.dtype))
    nx, ny, nz = gx / norm, gy / norm, gz / norm
    s = (rounded(F32(p.vorticity) * F32(p.dt), vx.dtype)
         * keep_vel[1:-1, 1:-1, 1:-1])
    out = []
    for v, f in ((vx, ny * wz - nz * wy), (vy, nz * wx - nx * wz),
                 (vz, nx * wy - ny * wx)):
        v = v.clone()
        v[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1] + s * f
        out.append(v)
    return tuple(out)


def inlets(state, p: Params):
    """The inlet plane x = 1 (simulation.cpp:64-67, 102-105): density +=
    inlet, vx = speed, vy = vz = 0 there; new fields."""
    vx, vy, vz, dens = state
    dt_ = dens.dtype
    D2, H2, W2 = dens.shape
    z = torch.arange(D2, device=dens.device).reshape(D2, 1, 1)
    y = torch.arange(H2, device=dens.device).reshape(1, H2, 1)
    x = torch.arange(W2, device=dens.device).reshape(1, 1, W2)
    plane = (x == 1) & (z >= 1) & (z <= D2 - 2) & (y >= 1) & (y <= H2 - 2)
    return (torch.where(plane, rounded(p.speed, dt_), vx),
            torch.where(plane, 0.0, vy), torch.where(plane, 0.0, vz),
            torch.where(plane, dens + rounded(p.inlet_density, dt_), dens))


def step(state, m: Masks, p: Params):
    """One split step with confinement from ``state`` = (vx, vy, vz,
    dens), padded fields of one dtype. Returns the new state and (density
    sum, max |divergence|) as float32 0-d tensors. The input is left
    unchanged."""
    vx, vy, vz, buffer = inlets(state, p)
    pv = (vx, vy, vz)

    a = F32(p.dt) * F32(p.diff) * F32(p.width) * F32(p.height) * F32(p.depth)
    c = F32(1.0) + F32(6.0) * a
    vx, vy, vz = (relax(b, v, v, a, c, m.keep_vel, m.red, p.acc, p.wall_mode)
                  for b, v in ((1, vx), (2, vy), (3, vz)))
    vx, vy, vz = project(vx, vy, vz, m, p)
    smp = advect(torch.stack(pv), vx, vy, vz, p)
    vx, vy, vz = (padded(smp[i], i + 1, m.keep_vel, m, p.wall_mode)
                  for i in range(3))
    vx, vy, vz = confine(vx, vy, vz, m.keep_vel, p)
    vx, vy, vz = project(vx, vy, vz, m, p)
    dens = padded(advect(buffer[None], vx, vy, vz, p)[0], 0, m.keep_scalar, m,
                  SCALAR_WALLS)
    max_div = divergence(vx, vy, vz, m, grid_h(p)).abs().max().to(
        torch.float32)
    return (vx, vy, vz, dens), (torch.sum(dens, dtype=torch.float32), max_div)
