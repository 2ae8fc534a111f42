"""The benchmark's plain compat step: one step of the wind tunnel in the
``SimParams`` default mode, in plain PyTorch, written from the C++
reference's semantics (Ghundi/fluid_simulation) for the configurations
whose ``reference`` is ``compat``.

It follows ``Simulation::run`` + ``Simulation::step`` (simulation.cpp:49-150)
with the reference's own advection:

  inlets         density += inlet on the x = 1 plane, vx = speed, vy = vz = 0
                 there (simulation.cpp:64-67, 102-105); buffer = density
                 (:70); the velocities saved before diffusion (:107-110);
  diffusion      vx, vy, vz each: ``acc`` red-black sweeps, faces and keep
                 (``step.relax``; simulation.cpp:251-284);
  projection     ``step.project`` (simulation.cpp:289-362);
  advection      ``Simulation::advect`` (simulation.cpp:367-424) of each
                 velocity component from its saved field, chained
                 (:125-127): vx first, then vy through the new vx, then vz
                 through both. For component b the backtrace reads b from
                 the saved field and the other two from the current fields
                 (:380-382): x - dt N v on each axis, N that axis's size
                 (:384-386), clamped to [0.5, N + 0.5] (:388-390); the sample
                 lerps the eight cells around it in x, then y, then z
                 (:392-420); solid cells are zero (:375-378); then
                 setBounds(b): the six faces (:183-216), then the keep
                 multiply;
  projection     again; then density advected from ``buffer`` the same way
                 (b = 0: all three components current);
  stats          the density sum and the largest |divergence| in float32.

Departures from the C++, which the configuration states:

- the solves sweep red-black (``solver: rbgs``), not in the C++'s
  sequential order;
- velocity diffuses with ``diff`` (``use_visc_for_velocity`` false);
- the density's diffusion (simulation.cpp:135) is not computed: its
  advection rewrites every cell from ``buffer``.

Every field is (D + 2, H + 2, W + 2), z-major, in the dtype of the state it
is given (float32, or bfloat16 for the benchmark's low-precision control).
Backtrace coordinates and lerp fractions are float32; a sample is lerped in
float32 (or the state's dtype, where wider) and rounded to the state's dtype
once. It keeps the contract in ``step.py``'s docstring and imports numpy,
torch and ``step.py`` only: nothing of the program.
"""

from __future__ import annotations

import torch

from .step import (F32, Masks, Params, divergence, faces_, grid_h, project,
                   relax, rounded)
from .step import build_masks  # noqa: F401  (the contract's masks)


def params_of(config: dict) -> Params:
    """The reference's parameters from a configuration file's fields; it
    computes compat mode with rbgs, ``diff`` for velocity and no vorticity
    confinement, and refuses any other configuration."""
    if (config["mode"], config["solver"], config["vorticity"],
            config["use_visc_for_velocity"]) != ("compat", "rbgs", 0.0,
                                                 False):
        raise NotImplementedError("the compat reference computes compat "
                                  "mode with rbgs, diff and no vorticity "
                                  "only")
    return Params(*(config[k] for k in Params._fields))


def inlets(state, p: Params):
    """The inlet plane x = 1 (simulation.cpp:64-67, 102-105): the new
    velocities and the new density, which is also ``buffer``."""
    vx, vy, vz, dens = state
    plane = torch.zeros(dens.shape, dtype=torch.bool, device=dens.device)
    plane[1:-1, 1:-1, 1] = True
    dens = torch.where(plane, dens + rounded(p.inlet_density, dens.dtype),
                       dens)
    vx = torch.where(plane, rounded(p.speed, vx.dtype), vx)
    return (vx, vy.masked_fill(plane, 0.0), vz.masked_fill(plane, 0.0)), dens


def departure(vel, p: Params):
    """The backtraced float32 coordinates (x, y, z) of every interior cell
    (simulation.cpp:384-390) through the padded velocities ``vel``."""
    out = []
    for axis, (n, v) in enumerate(zip((p.width, p.height, p.depth), vel)):
        shape = [1, 1, 1]
        shape[2 - axis] = n
        i = torch.arange(1, n + 1, dtype=torch.float32,
                         device=v.device).reshape(shape)
        dtn = float(F32(p.dt) * F32(n))
        c = i - dtn * v[1:-1, 1:-1, 1:-1].to(torch.float32)
        out.append(c.clamp(0.5, float(F32(n) + F32(0.5))))
    return out


def sample(prev, x, y, z):
    """Trilinear sample of the padded ``prev`` at (x, y, z), interior-shaped
    (simulation.cpp:392-420): the cells at floor and floor + 1 of each
    coordinate, lerped in x, then y, then z."""
    i0, j0, k0 = (torch.floor(c) for c in (x, y, z))
    sx, sy, sz = x - i0, y - j0, z - k0
    i0, j0, k0 = (c.to(torch.int64) for c in (i0, j0, k0))
    i1, j1, k1 = i0 + 1, j0 + 1, k0 + 1

    def lerp(a, b, s):
        return a * (1.0 - s) + b * s

    rows = [lerp(prev[k, j, i0], prev[k, j, i1], sx)
            for k, j in ((k0, j0), (k0, j1), (k1, j0), (k1, j1))]
    near, far = lerp(rows[0], rows[1], sy), lerp(rows[2], rows[3], sy)
    return lerp(near, far, sz).to(prev.dtype)


def advect(b, prev, vel, keep, m: Masks, p: Params):
    """``Simulation::advect(b, ...)``: ``prev`` sampled along the backtrace
    through ``vel`` (the three components it reads), zero in solids, then
    setBounds(b): faces, then ``keep``. Returns a new padded field."""
    out = torch.zeros_like(prev)
    out[1:-1, 1:-1, 1:-1] = sample(prev, *departure(vel, p)) * m.fluid
    return faces_(out, b, p.wall_mode) * keep


def step(state, m: Masks, p: Params):
    """One compat step from ``state`` = (vx, vy, vz, dens), padded fields of
    one dtype. Returns the new state and (density sum, max |divergence|)
    as float32 0-d tensors. The input is left unchanged."""
    (vx, vy, vz), dens = inlets(state, p)
    buffer, (pvx, pvy, pvz) = dens, (vx, vy, vz)

    a = F32(p.dt) * F32(p.diff) * F32(p.width) * F32(p.height) * F32(p.depth)
    c = F32(1.0) + F32(6.0) * a
    vx, vy, vz = (relax(b, v, v, a, c, m.keep_vel, m.red, p.acc, p.wall_mode)
                  for b, v in ((1, vx), (2, vy), (3, vz)))
    vx, vy, vz = project(vx, vy, vz, m, p)
    vx = advect(1, pvx, (pvx, vy, vz), m.keep_vel, m, p)
    vy = advect(2, pvy, (vx, pvy, vz), m.keep_vel, m, p)
    vz = advect(3, pvz, (vx, vy, pvz), m.keep_vel, m, p)
    vx, vy, vz = project(vx, vy, vz, m, p)
    dens = advect(0, buffer, (vx, vy, vz), m.keep_scalar, m, p)
    max_div = divergence(vx, vy, vz, m, grid_h(p)).abs().max().to(
        torch.float32)
    return (vx, vy, vz, dens), (torch.sum(dens, dtype=torch.float32), max_div)
