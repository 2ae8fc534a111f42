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
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build


def _axis_constants(dt: float, n: int):
    """(dt*N rounded to f32, upper clamp N+0.5) as the JAX package rounds
    them (``np.float32(dt) * np.float32(N)``)."""
    return (float(np.float32(dt) * np.float32(n)),
            float(np.float32(n) + np.float32(0.5)))


def advect_split_plain(prev, vx, vy, vz, dt: float):
    """The three passes in plain torch, coordinates in f32."""
    squeeze = prev.ndim == 3
    if squeeze:
        prev = prev[None]
    dtype, dev = prev.dtype, prev.device
    _, D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2

    def coords(n, shape, v):
        dtN, hi = _axis_constants(dt, n)
        i = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
        return (i.reshape(shape) - dtN * v.to(torch.float32)).clamp(0.5, hi)

    def lerp(arr, c, axis):
        i0 = torch.floor(c).to(torch.int64)
        s = c - i0.to(torch.float32)
        i0 = i0.unsqueeze(0).expand(arr.shape[0], *i0.shape)
        a = torch.gather(arr, axis, i0)
        b = torch.gather(arr, axis, i0 + 1)
        return (a * (1.0 - s) + b * s).to(dtype)

    A = lerp(prev, coords(W, (1, 1, W), vx[:, :, 1:-1]), 3)
    B = lerp(A, coords(H, (1, H, 1), vy[:, 1:-1, 1:-1]), 2)
    out = lerp(B, coords(D, (D, 1, 1), vz[1:-1, 1:-1, 1:-1]), 1)
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
    ptr = _build.ptr
    # (src, vel, dst, out dims, gather axis, src length there, vel offsets, N)
    passes = ((prev, vx, a, (D2, H2, W), 2, W2, (0, 0, 1), W),
              (a, vy, b, (D2, H, W), 1, H2, (0, 1, 1), H),
              (b, vz, out, (D, H, W), 0, D2, (1, 1, 1), D))
    with torch.cuda.device(prev.device):
        stream = _build.stream(prev)
        for src, vel, dst, dims, axis, g, off, n in passes:
            dtN, hi = _axis_constants(dt, n)
            _build.call("fst_lerp_pass", ptr(src), ptr(vel), ptr(dst), Bn,
                        *dims, axis, g, H2, W2, *off, dtN, hi, stream)
