"""The benchmark's plain reference: one split-mode step of the wind tunnel in
plain PyTorch, written from the C++ reference's semantics and frozen here.

It follows ``Simulation::run`` + ``Simulation::step`` (simulation.cpp:49-150)
with the split advection and the padded layout of the wind tunnel:

  inlets         density += inlet on the x = 1 plane, vx = speed, vy = vz = 0
                 there (simulation.cpp:64-67, 102-105); buffer = density;
  diffusion      vx, vy, vz each: ``acc`` red-black Gauss-Seidel sweeps of
                 f = (prev + a * sum6(f)) / c, then the ghost faces, then the
                 keep mask (simulation.cpp:251-284);
  projection     divergence over fluid neighbours, a Poisson solve (a = 1,
                 c = 6), central / one-sided gradient subtraction, faces and
                 keep (simulation.cpp:289-362);
  advection      three 1-D lerp passes (x, y, z) of the pre-diffusion
                 velocities through the projected field, coordinates in
                 float32, clamped to [0.5, N + 0.5]; the padded result takes
                 the signed mirror of its pre-keep edge as its faces, zero
                 ghost edges and corners;
  projection     again; then density advected from ``buffer`` the same way;
  stats          the density sum and the largest |divergence| in float32.

Every field is (D + 2, H + 2, W + 2), z-major. The masks are derived again
here from the padded obstacle field (1 = solid). The step computes in the
dtype of the state it is given (float32, or bfloat16 for the benchmark's
low-precision control); backtrace coordinates and stats stay float32.

This module imports only numpy and torch: nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

F32 = np.float32


class Masks(NamedTuple):
    """Masks of one scene (padded (D+2, H+2, W+2) or interior (D, H, W))."""

    keep_scalar: torch.Tensor   # padded: 0 in solids
    keep_vel: torch.Tensor      # padded: 0 in solids and their 6-neighbours
    fluid: torch.Tensor         # interior: 1 in fluid
    red: torch.Tensor           # interior bool: 1-based x + y + z even
    nb: Tuple[torch.Tensor, ...]  # interior: x+, x-, y+, y-, z+, z- valid


class Params(NamedTuple):
    """The physics of a configuration (``SimParams``'s field names)."""

    width: int
    height: int
    depth: int
    dt: float
    diff: float
    acc: int
    speed: float
    inlet_density: float
    wall_mode: str


def params_of(config: dict) -> Params:
    """The reference's parameters from a configuration file's fields; it
    computes the split step with rbgs, ``diff`` for velocity and no
    vorticity confinement, and refuses any other configuration."""
    if (config["mode"], config["solver"], config["vorticity"],
            config["use_visc_for_velocity"]) != ("split", "rbgs", 0.0, False):
        raise NotImplementedError("the reference computes split mode with "
                                  "rbgs, diff and no vorticity only")
    return Params(*(config[k] for k in Params._fields))


def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to float32 and then to ``dtype``, as a Python float."""
    return float(torch.tensor(float(F32(x)), dtype=dtype))


def build_masks(obstacles, dtype=torch.float32, device="cpu") -> Masks:
    """The masks of a padded obstacle field (numpy or tensor, 1 = solid)."""
    solid = (torch.as_tensor(np.asarray(obstacles, np.float32)
                             if not isinstance(obstacles, torch.Tensor)
                             else obstacles, device=device)
             >= 0.5).to(torch.float32)
    s_i = solid[1:-1, 1:-1, 1:-1]
    fluid = 1.0 - s_i
    near = (solid[1:-1, 1:-1, 2:] + solid[1:-1, 1:-1, :-2]
            + solid[1:-1, 2:, 1:-1] + solid[1:-1, :-2, 1:-1]
            + solid[2:, 1:-1, 1:-1] + solid[:-2, 1:-1, 1:-1]) > 0
    keep_scalar = torch.ones_like(solid)
    keep_scalar[1:-1, 1:-1, 1:-1] = fluid
    keep_vel = torch.ones_like(solid)
    keep_vel[1:-1, 1:-1, 1:-1] = fluid * (~near).to(torch.float32)
    # a neighbour counts where it is fluid and inside the interior
    fp = torch.zeros_like(solid)
    fp[1:-1, 1:-1, 1:-1] = fluid
    nb = (fp[1:-1, 1:-1, 2:], fp[1:-1, 1:-1, :-2], fp[1:-1, 2:, 1:-1],
          fp[1:-1, :-2, 1:-1], fp[2:, 1:-1, 1:-1], fp[:-2, 1:-1, 1:-1])
    D, H, W = s_i.shape
    z = torch.arange(1, D + 1, device=device).reshape(D, 1, 1)
    y = torch.arange(1, H + 1, device=device).reshape(1, H, 1)
    x = torch.arange(1, W + 1, device=device).reshape(1, 1, W)
    red = (z + y + x) % 2 == 0

    def cast(t):
        return t.to(dtype).contiguous()

    return Masks(cast(keep_scalar), cast(keep_vel), cast(fluid), red,
                 tuple(cast(t) for t in nb))


def signs(b: int, wall_mode: str):
    """Ghost-face mirror signs (x, y, z) of field tag ``b`` (0 density,
    1-3 velocity x-z); the x+ face is always a plain copy."""
    if wall_mode == "noslip" and b:
        return (-1.0 if b == 1 else 1.0), -1.0, -1.0
    if wall_mode != "reference":
        raise ValueError(f"unknown wall_mode {wall_mode!r}")
    return tuple(-1.0 if b == k else 1.0 for k in (1, 2, 3))


def faces_(f, b, wall_mode):
    """setBounds' six face writes (simulation.cpp:183-216), in place."""
    sx, sy, sz = signs(b, wall_mode)
    f[1:-1, 1:-1, 0] = sx * f[1:-1, 1:-1, 1]
    f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
    f[1:-1, 0, 1:-1] = sy * f[1:-1, 1, 1:-1]
    f[1:-1, -1, 1:-1] = sy * f[1:-1, -2, 1:-1]
    f[0, 1:-1, 1:-1] = sz * f[1, 1:-1, 1:-1]
    f[-1, 1:-1, 1:-1] = sz * f[-2, 1:-1, 1:-1]
    return f


def relax(b, f, rhs, a, c, keep, red, acc, wall_mode):
    """``acc`` red-black sweeps (red cells first), each followed by the faces
    of ``b`` and the keep multiply; returns a new field."""
    a = rounded(a, f.dtype)
    c_recip = rounded(F32(1.0) / F32(c), f.dtype)
    f = f.clone()
    inner = f[1:-1, 1:-1, 1:-1]
    rhs_i = rhs[1:-1, 1:-1, 1:-1]
    for _ in range(acc):
        for colour in (red, ~red):
            s = (((((f[1:-1, 1:-1, 2:] + f[1:-1, 1:-1, :-2])
                    + f[1:-1, 2:, 1:-1]) + f[1:-1, :-2, 1:-1])
                  + f[2:, 1:-1, 1:-1]) + f[:-2, 1:-1, 1:-1])
            inner.copy_(torch.where(colour, (rhs_i + a * s) * c_recip, inner))
        faces_(f, b, wall_mode)
        f.mul_(keep)
    return f


def grid_h(p: Params) -> F32:
    """The mesh spacing 1 / cbrt(W H D) in float32 (simulation.cpp:295)."""
    return F32(1.0) / np.cbrt(F32(p.width * p.height * p.depth))


def divergence(vx, vy, vz, m: Masks, h) -> torch.Tensor:
    """-0.5 h times the central divergence over fluid neighbours, zero in
    solids, on the interior (simulation.cpp:297-316)."""
    xp, xm, yp, ym, zp, zm = m.nb
    val = (vx[1:-1, 1:-1, 2:] * xp - vx[1:-1, 1:-1, :-2] * xm
           + vy[1:-1, 2:, 1:-1] * yp - vy[1:-1, :-2, 1:-1] * ym
           + vz[2:, 1:-1, 1:-1] * zp - vz[:-2, 1:-1, 1:-1] * zm)
    return rounded(F32(-0.5) * h, vx.dtype) * val * m.fluid


def project(vx, vy, vz, m: Masks, p: Params):
    """The pressure projection (simulation.cpp:289-362); new fields."""
    h = grid_h(p)
    div = torch.zeros_like(vx)
    div[1:-1, 1:-1, 1:-1] = divergence(vx, vy, vz, m, h)
    div = faces_(div, 0, p.wall_mode) * m.keep_scalar
    pr = relax(0, torch.zeros_like(vx), div, 1.0, 6.0, m.keep_scalar, m.red,
               p.acc, p.wall_mode)
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


def lerp_pass(src, vel, axis, n, dt, off):
    """One 1-D pass: ``src`` (B, S0, S1, S2) sampled along ``axis`` (length
    n + 2) at clip(i - dt n v, 0.5, n + 0.5), i = 1..n, v read from ``vel``
    at the output index plus ``off``."""
    dims = list(src.shape[1:])
    dims[axis] = n
    shape = [1, 1, 1]
    shape[axis] = n
    i = torch.arange(1, n + 1, dtype=torch.float32, device=src.device)
    v = vel[off[0]:off[0] + dims[0], off[1]:off[1] + dims[1],
            off[2]:off[2] + dims[2]].to(torch.float32)
    dtn = float(F32(dt) * F32(n))
    c = (i.reshape(shape) - dtn * v).clamp(0.5, float(F32(n) + F32(0.5)))
    i0 = torch.floor(c).to(torch.int64)
    s = c - i0.to(torch.float32)
    i0 = i0.expand(src.shape[0], *i0.shape)
    lo = torch.gather(src, axis + 1, i0)
    hi = torch.gather(src, axis + 1, i0 + 1)
    return (lo * (1.0 - s) + hi * s).to(src.dtype)


def advect(stack, vx, vy, vz, p: Params):
    """Split advection of a stack (B, D+2, H+2, W+2); the interiors
    (B, D, H, W)."""
    a = lerp_pass(stack, vx, 2, p.width, p.dt, (0, 0, 1))
    a = lerp_pass(a, vy, 1, p.height, p.dt, (0, 1, 1))
    return lerp_pass(a, vz, 0, p.depth, p.dt, (1, 1, 1))


def padded(smp, b, keep, m: Masks, wall_mode):
    """A padded field from an advected interior: interior smp * fluid * keep,
    faces the signed mirror of smp * fluid at the edge (x+ a copy), ghost
    edges and corners zero."""
    iv = smp * m.fluid
    sx, sy, sz = signs(b, wall_mode)
    D, H, W = smp.shape
    out = smp.new_zeros((D + 2, H + 2, W + 2))
    out[1:-1, 1:-1, 1:-1] = iv * keep[1:-1, 1:-1, 1:-1]
    out[1:-1, 1:-1, 0] = sx * iv[:, :, 0]
    out[1:-1, 1:-1, -1] = iv[:, :, -1]
    out[1:-1, 0, 1:-1] = sy * iv[:, 0, :]
    out[1:-1, -1, 1:-1] = sy * iv[:, -1, :]
    out[0, 1:-1, 1:-1] = sz * iv[0]
    out[-1, 1:-1, 1:-1] = sz * iv[-1]
    return out


def step(state, m: Masks, p: Params):
    """One split step from ``state`` = (vx, vy, vz, dens), padded fields of
    one dtype. Returns the new state and (density sum, max |divergence|)
    as float32 0-d tensors. The input is left unchanged."""
    vx, vy, vz, dens = state
    dt_ = dens.dtype
    D2, H2, W2 = dens.shape
    z = torch.arange(D2, device=dens.device).reshape(D2, 1, 1)
    y = torch.arange(H2, device=dens.device).reshape(1, H2, 1)
    x = torch.arange(W2, device=dens.device).reshape(1, 1, W2)
    inlet = (x == 1) & (z >= 1) & (z <= D2 - 2) & (y >= 1) & (y <= H2 - 2)
    dens = torch.where(inlet, dens + rounded(p.inlet_density, dt_), dens)
    vx = torch.where(inlet, rounded(p.speed, dt_), vx)
    vy = torch.where(inlet, 0.0, vy)
    vz = torch.where(inlet, 0.0, vz)
    buffer, pv = dens, (vx, vy, vz)

    a = F32(p.dt) * F32(p.diff) * F32(p.width) * F32(p.height) * F32(p.depth)
    c = F32(1.0) + F32(6.0) * a
    vx, vy, vz = (relax(b, v, v, a, c, m.keep_vel, m.red, p.acc, p.wall_mode)
                  for b, v in ((1, vx), (2, vy), (3, vz)))
    vx, vy, vz = project(vx, vy, vz, m, p)
    smp = advect(torch.stack(pv), vx, vy, vz, p)
    vx, vy, vz = (padded(smp[i], i + 1, m.keep_vel, m, p.wall_mode)
                  for i in range(3))
    vx, vy, vz = project(vx, vy, vz, m, p)
    dens = padded(advect(buffer[None], vx, vy, vz, p)[0], 0, m.keep_scalar, m,
                  p.wall_mode)
    max_div = divergence(vx, vy, vz, m, grid_h(p)).abs().max().to(
        torch.float32)
    return (vx, vy, vz, dens), (torch.sum(dens, dtype=torch.float32), max_div)
