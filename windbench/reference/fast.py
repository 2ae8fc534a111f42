"""The benchmark's plain fast step: one step of the wind tunnel in fast
mode, in plain PyTorch, for the configurations whose ``reference`` is
``fast``.

Fast mode is one of the JAX package's three ``--mode`` choices
(``fluid_simulation_tpu/cli.py:42``), its step the fast branch of
``fluid_simulation_tpu/models/windtunnel.py`` (:339-355). It keeps the
reference's step (Ghundi/fluid_simulation, ``Simulation::run`` +
``Simulation::step``, simulation.cpp:49-150) and its physics
(simulation.h:59-64), and shares one backtrace among the velocity
components, as Stam's "Real-Time Fluid Dynamics for Games" (GDC 2003)
does in ``vel_step``, where u and v both follow the backtrace of one
(u0, v0). Only the backtrace is Stam's: he samples the projected u0, v0
themselves, where fast samples the reference's pre-diffusion saves.

  inlets         ``compat.inlets`` (simulation.cpp:64-67, 70, 102-105);
                 the velocities saved before diffusion (:107-110);
  diffusion      vx, vy, vz each: ``acc`` red-black sweeps, faces and keep
                 (``step.relax``; simulation.cpp:251-284);
  projection     ``step.project`` (simulation.cpp:289-362);
  advection      **one** backtrace, through the projected velocity (x -
                 dt N v on each axis, N that axis's size, clamped to [0.5,
                 N + 0.5]; simulation.cpp:384-390); the saved vx, vy and vz
                 each sampled there (the eight cells around the point
                 lerped in x, then y, then z; :392-420), zero in solids
                 (:375-378), then setBounds(b) for b = 1, 2, 3: the six
                 faces (:183-216), then the keep multiply. Each is one
                 ``compat.advect`` call given the projected field, so the
                 three compute the same coordinates;
  vorticity      none;
  projection     again; then density advected from ``buffer`` as
                 ``compat.advect`` does (b = 0: the backtrace through the
                 current fields);
  stats          the density sum and the largest |divergence| in float32.

Departures from the C++, which the configuration states:

- the three velocity components share one backtrace, through the
  projected field, where the C++ chains them (simulation.cpp:125-127): for
  component b it reads b from the saved field and the other two from the
  fields that the components before it produced (:380-382);
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
torch, ``step.py`` and ``compat.py`` only: nothing of the program.
"""

from __future__ import annotations

import torch

from .compat import advect, inlets
from .step import F32, Masks, Params, divergence, grid_h, project, relax
from .step import build_masks  # noqa: F401  (the contract's masks)


def params_of(config: dict) -> Params:
    """The reference's parameters from a configuration file's fields; it
    computes fast mode with rbgs, ``diff`` for velocity and no vorticity
    confinement, and refuses any other configuration."""
    if (config["mode"], config["solver"], config["vorticity"],
            config["use_visc_for_velocity"]) != ("fast", "rbgs", 0.0, False):
        raise NotImplementedError("the fast reference computes fast mode "
                                  "with rbgs, diff and no vorticity only")
    return Params(*(config[k] for k in Params._fields))


def step(state, m: Masks, p: Params):
    """One fast step from ``state`` = (vx, vy, vz, dens), padded fields of
    one dtype. Returns the new state and (density sum, max |divergence|)
    as float32 0-d tensors. The input is left unchanged."""
    (vx, vy, vz), dens = inlets(state, p)
    buffer, saved = dens, (vx, vy, vz)

    a = F32(p.dt) * F32(p.diff) * F32(p.width) * F32(p.height) * F32(p.depth)
    c = F32(1.0) + F32(6.0) * a
    vx, vy, vz = (relax(b, v, v, a, c, m.keep_vel, m.red, p.acc, p.wall_mode)
                  for b, v in ((1, vx), (2, vy), (3, vz)))
    vx, vy, vz = project(vx, vy, vz, m, p)
    projected = (vx, vy, vz)
    vx, vy, vz = (advect(b, prev, projected, m.keep_vel, m, p)
                  for b, prev in zip((1, 2, 3), saved))
    vx, vy, vz = project(vx, vy, vz, m, p)
    dens = advect(0, buffer, (vx, vy, vz), m.keep_scalar, m, p)
    max_div = divergence(vx, vy, vz, m, grid_h(p)).abs().max().to(
        torch.float32)
    return (vx, vy, vz, dens), (torch.sum(dens, dtype=torch.float32), max_div)
