"""Kernel 10: vorticity confinement (``csrc/vorticity.cu``) and its plain torch
version.

Port of ``fluid_simulation_tpu/kernels/vorticity_pallas.py::pallas_confinement``:
the curl omega of the velocity, the central gradient of |omega| with a zero
ghost shell, ``N = grad|omega| / (|grad|omega|| + 1e-5)``, and
``v += eps*dt*keep*(N x omega)`` on the interior; the ghost faces are left
as they were.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar
from fluid_simulation_tpu_torch.ops.vorticity import add_force, force


def confinement_plain(vx, vy, vz, keep_vel_i, eps: float, dt: float):
    """The confinement in plain torch (``ops.vorticity``'s arithmetic);
    ``keep_vel_i`` is the interior keep mask. Returns three new tensors."""
    return add_force((vx, vy, vz),
                     force(vx, vy, vz, keep_vel_i.to(vx.dtype), eps, dt))


def confinement(vx, vy, vz, keep_vel_i, eps: float, dt: float):
    """Vorticity confinement of padded (vx, vy, vz); returns three new
    tensors. ``keep_vel_i`` is interior-shaped (a view of the padded
    ``keep_vel`` is fine). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if not _build.on_card(vx):
        return confinement_plain(vx, vy, vz, keep_vel_i, eps, dt)
    _build.check_operands("confinement", (vx, vy, vz),
                          (None, vx.shape, vx.shape))
    if vx.ndim != 3 or min(vx.shape) < 3:
        raise ValueError(f"confinement: bad padded shape {tuple(vx.shape)}")
    D, H, W = (n - 2 for n in vx.shape)
    _build.mask_view("confinement", keep_vel_i, (D, H, W), vx.get_device())
    outs = tuple(torch.empty_like(vx) for _ in range(3))
    w = torch.empty((3, D, H, W), dtype=vx.dtype, device=vx.device)
    mag = torch.zeros_like(vx)    # |omega|; its zero ghost shell is read
    _launch(vx, vy, vz, keep_vel_i, w, mag, outs, eps, dt)
    LAUNCHES["confinement"] += 1
    return outs


def _launch(vx, vy, vz, keep_vel_i, w, mag, outs, eps, dt):
    """The curl launch (into ``w`` and ``mag``), then the update launch
    (into ``outs``)."""
    D, H, W = (n - 2 for n in vx.shape)
    s_lit = as_scalar(np.float32(eps) * np.float32(dt), torch.float32)
    ptr, dev = _build.ptr, vx.get_device()
    kp = _build.mask_view("confinement", keep_vel_i, (D, H, W), dev)
    _build.launch("fst_curl", dev, ptr(vx), ptr(vy), ptr(vz), ptr(w),
                  ptr(mag), D, H, W)
    _build.launch("fst_confine", dev, ptr(vx), ptr(vy), ptr(vz), ptr(w),
                  ptr(mag), *kp, *map(ptr, outs), D, H, W, s_lit)
