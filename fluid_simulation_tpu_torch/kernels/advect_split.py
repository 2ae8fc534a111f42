"""Kernel 3: operator-split advection (``csrc/advect_split.cu``) and its plain
torch version.

Port of ``fluid_simulation_tpu/kernels/advect_pallas.py::advect_split_t``
(and of ``advect_split_jnp``, its XLA version): three 1-D lerp-gather passes,
x then y then z,

    A(z,y,x) = lerp_x(prev(z,y,:),  x - dt*W*vx)   every (z, y) row, ghosts too
    B(z,y,x) = lerp_y(A(z,:,x),     y - dt*H*vy)   every z row, ghosts too
    out      = lerp_z(B(:,y,x),     z - dt*D*vz)

with each coordinate clamped to ``[0.5, N+0.5]``. ``prev`` is one padded
field or a stack (Bn, D+2, H+2, W+2) advected through the same velocity.
Returns the advected interior(s) (Bn?, D, H, W).

``advect_split_fused`` is the port of the JAX package's second entry point
to the same function, ``advect_pallas.py::advect_split_fused``, whose TPU
pass kernel ``_lane_pass`` (ROADMAP B18) computes the backtrace
``clip(i - dt*N*v)`` inside the pass. The card's pass kernel already does
that for every pass, so the two TPU entry points share one Hopper kernel;
each wrapper counts its own launches.

``lerp_pass`` runs one pass of the same kernel on any stack and axis (the
transpose probe's boundary rows, ``tools/exp_transpose.py``; no route).
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build


def _upper(n: int) -> float:
    """The backtrace's upper clamp N + 0.5, rounded to f32."""
    return float(np.float32(n) + np.float32(0.5))


def _axis_constants(dt: float, n: int):
    """(dt*N rounded to f32, upper clamp N+0.5) as the JAX package rounds
    them (``np.float32(dt) * np.float32(N)``)."""
    return float(np.float32(dt) * np.float32(n)), _upper(n)


def advect_split_plain(prev, vx, vy, vz, dt: float):
    """The three passes in plain torch, coordinates in f32."""
    squeeze = prev.ndim == 3
    if squeeze:
        prev = prev[None]
    _, D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    A = lerp_pass_plain(prev, vx, 2, _axis_constants(dt, W)[0], (0, 0, 1))
    B = lerp_pass_plain(A, vy, 1, _axis_constants(dt, H)[0], (0, 1, 1))
    out = lerp_pass_plain(B, vz, 0, _axis_constants(dt, D)[0], (1, 1, 1))
    return out[0] if squeeze else out


def advect_split(prev, vx, vy, vz, dt: float):
    """Split advection of padded field(s) ``prev`` through (vx, vy, vz).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (once per pass) or raises."""
    return _split("advect_split", prev, vx, vy, vz, dt)


def advect_split_fused(prev, vx, vy, vz, dt: float):
    """The fused-backtrace entry point (``advect_split_fused`` of the JAX
    package, opt-in there and routed by no step here): the same passes
    through the same kernel as ``advect_split``, counted under its own
    name. Its plain version is ``advect_split_plain``."""
    return _split("advect_split_fused", prev, vx, vy, vz, dt)


def _split(name, prev, vx, vy, vz, dt):
    if not _build.on_card(prev):
        return advect_split_plain(prev, vx, vy, vz, dt)
    squeeze = prev.ndim == 3
    if squeeze:
        prev = prev[None]
    if prev.ndim != 4 or min(prev.shape[1:]) < 3:
        raise ValueError(f"{name}: bad field shape {tuple(prev.shape)}")
    pad = prev.shape[1:]
    _build.check_operands(name, (prev, vx, vy, vz), (None, pad, pad, pad))
    Bn, D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    a = torch.empty((Bn, D2, H2, W), dtype=prev.dtype, device=prev.device)
    b = torch.empty((Bn, D2, H, W), dtype=prev.dtype, device=prev.device)
    out = torch.empty((Bn, D, H, W), dtype=prev.dtype, device=prev.device)
    _launch(prev, vx, vy, vz, a, b, out, dt)
    LAUNCHES[name] += 1
    return out[0] if squeeze else out


def _launch(prev, vx, vy, vz, a, b, out, dt):
    """The x, y and z passes: prev -> a -> b -> out."""
    Bn, D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    ptr, dev = _build.ptr, prev.get_device()
    # (src, vel, dst, out dims, gather axis, src length there, vel offsets, N)
    passes = ((prev, vx, a, (D2, H2, W), 2, W2, (0, 0, 1), W),
              (a, vy, b, (D2, H, W), 1, H2, (0, 1, 1), H),
              (b, vz, out, (D, H, W), 0, D2, (1, 1, 1), D))
    for src, vel, dst, dims, axis, g, off, n in passes:
        dtN, hi = _axis_constants(dt, n)
        _build.launch("fst_lerp_pass", dev, ptr(src), ptr(vel), ptr(dst), Bn,
                      *dims, axis, g, H2, W2, *off, dtN, hi)


def lerp_pass_plain(src: torch.Tensor, vel: torch.Tensor, axis: int,
                    dtN: float, off=(0, 0, 0)) -> torch.Tensor:
    """One pass in plain torch: ``src`` (Bn, S0, S1, S2) gathered along
    ``axis`` (0-2, of the last three) of length N + 2 at the backtrace
    ``clip(i - dtN*v, 0.5, N + 0.5)``, i = 1..N, with v read from the 3-D
    ``vel`` at the output index plus ``off``. Returns (Bn, O0, O1, O2), O
    the source's dims with N on ``axis``."""
    dims = _pass_dims(src, vel, axis, off)
    n = dims[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    i = torch.arange(1, n + 1, dtype=torch.float32, device=src.device)
    v = vel[off[0]:off[0] + dims[0], off[1]:off[1] + dims[1],
            off[2]:off[2] + dims[2]]
    c = (i.reshape(shape) - dtN * v.to(torch.float32)).clamp(0.5, _upper(n))
    i0 = torch.floor(c).to(torch.int64)
    s = c - i0.to(torch.float32)
    i0 = i0.unsqueeze(0).expand(src.shape[0], *i0.shape)
    a = torch.gather(src, axis + 1, i0)
    b = torch.gather(src, axis + 1, i0 + 1)
    return (a * (1.0 - s) + b * s).to(src.dtype)


def lerp_pass(src: torch.Tensor, vel: torch.Tensor, axis: int, dtN: float,
              off=(0, 0, 0)) -> torch.Tensor:
    """One pass of K3's kernel (``lerp_pass_plain``'s function) as a new
    tensor. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one launch) or raises."""
    dims = _pass_dims(src, vel, axis, off)
    if not _build.on_card(src):
        return lerp_pass_plain(src, vel, axis, dtN, off)
    name = "lerp_pass"
    _build.check_operands(name, (src, vel))
    out = torch.empty((src.shape[0], *dims), dtype=src.dtype,
                      device=src.device)
    _launch_pass(src, vel, out, axis, dtN, off)
    LAUNCHES[name] += 1
    return out


def _launch_pass(src, vel, out, axis, dtN, off):
    Bn, *dims = out.shape
    _build.launch("fst_lerp_pass", src.get_device(), _build.ptr(src),
                  _build.ptr(vel), _build.ptr(out), Bn, *dims, axis,
                  src.shape[axis + 1], vel.shape[1], vel.shape[2], *off,
                  float(dtN), _upper(dims[axis]))


def _pass_dims(src, vel, axis, off):
    """The output dims of a pass; raises on shapes the kernel does not
    take."""
    if src.ndim != 4 or vel.ndim != 3 or axis not in (0, 1, 2) \
            or src.shape[axis + 1] < 3:
        raise ValueError(f"lerp_pass: bad source {tuple(src.shape)}, "
                         f"velocity {tuple(vel.shape)} or axis {axis}")
    dims = list(src.shape[1:])
    dims[axis] -= 2
    if any(o < 0 or o + d > v for o, d, v in zip(off, dims, vel.shape)):
        raise ValueError(f"lerp_pass: velocity {tuple(vel.shape)} does not "
                         f"cover the output {tuple(dims)} at offset {off}")
    return dims
