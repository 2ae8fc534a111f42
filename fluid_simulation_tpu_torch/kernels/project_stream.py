"""Kernel 14: the streamed pressure projection of big grids
(``csrc/project_stream.cu`` plus ``csrc/rbgs_stream.cu``'s passes) and its
plain torch version, for an empty scene and for an obstacle scene.

Port of ``fluid_simulation_tpu/kernels/project_stream.py``:
``pallas_project_stream_packed`` (empty) and ``pallas_project_stream_masked``
(obstacles). Three stages, the result packed:

1. the divergence of the padded velocities into a packed rhs, pre-scaled
   by ``-0.5h`` (in-bounds selects; obstacle scenes: the fluid-neighbour
   masks rebuilt from ``fluid_i``, times ``fluid_i``);
2. ``acc`` sweeps of the Poisson solve as streamed passes (b = 0, a = 1,
   c = 6; obstacle scenes with keep = ``fluid_i``), from ``fpre = 0``: p is
   zero before sweep 1, so the passes' ``sign * fpre`` ghost reads are
   exactly p's zero ghosts and no sweep-1 kernel is needed;
3. the gradient of p (obstacle scenes: ``p = fpre * fluid_i``, the solve's
   final keep) subtracted from the velocities' interiors: empty scenes with
   the central / one-sided / zero selects, obstacle scenes with the 0/1
   mask algebra and ``v - grad * fluid_i``.

The result is ``(3, D, H, W)``; the step rebuilds the padded velocities with
its pad_bounds tail (kernel 4), which makes this equal to the resident
``kernels.project.project_empty`` / ``project_masked`` on every state the
step makes (ghost edges zero, velocities zero in solid cells).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls
from fluid_simulation_tpu_torch.kernels.project import (
    _coefficients, divergence_plain, masked_gradients, select_gradients)


def _self_padded(p):
    """``p`` with a ghost shell that repeats its edge: an out-of-domain
    neighbour's pressure is the cell's own."""
    return F.pad(p[None], (1, 1, 1, 1, 1, 1), mode="replicate")[0]


def gradient_packed_plain(vx, vy, vz, fpre, fluid_i=None):
    """Stage 3 in plain torch: the padded velocities' interiors minus the
    gradient of the packed solve result ``fpre``, stacked (3, D, H, W)."""
    vel = (vx, vy, vz)
    if fluid_i is None:
        grads = select_gradients(_self_padded(fpre))
        return torch.stack([v[1:-1, 1:-1, 1:-1] - g
                            for v, g in zip(vel, grads)])
    fl = fluid_i.to(fpre.dtype)
    grads = masked_gradients(_self_padded(fpre * fl), fl)
    return torch.stack([v[1:-1, 1:-1, 1:-1] - g * fl
                        for v, g in zip(vel, grads)])


def project_stream_plain(vx, vy, vz, acc: int = 15,
                         wall_mode: str = "reference", nsw: int = ls.NSW):
    """The empty-scene streamed projection in plain torch; (3, D, H, W)."""
    rhs = divergence_plain(vx, vy, vz)
    fpre = ls.passes_plain(torch.zeros_like(rhs), rhs, None, 0, 1.0, 6.0,
                           acc, nsw, wall_mode)
    return gradient_packed_plain(vx, vy, vz, fpre)


def project_stream_masked_plain(vx, vy, vz, fluid_i, acc: int = 15,
                                wall_mode: str = "reference",
                                nsw: int = ls.NSW):
    """The obstacle-scene streamed projection in plain torch; (3, D, H, W).
    ``fluid_i`` is the interior fluid mask (``masks.fluid_i``)."""
    fl = fluid_i.to(vx.dtype)
    rhs = divergence_plain(vx, vy, vz, fl)
    fpre = ls.passes_plain(torch.zeros_like(rhs), rhs, fl, 0, 1.0, 6.0, acc,
                           nsw, wall_mode)
    return gradient_packed_plain(vx, vy, vz, fpre, fl)


def project_stream(vx, vy, vz, acc: int = 15, wall_mode: str = "reference",
                   nsw: int = ls.NSW):
    """Project padded (vx, vy, vz) of an empty scene through the streamed
    kernels; returns the projected interiors (3, D, H, W) for the step's
    pad_bounds tail. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernels or raises."""
    if not _build.on_card(vx):
        return project_stream_plain(vx, vy, vz, acc, wall_mode, nsw)
    return _project_on_card("project_stream", vx, vy, vz, None, acc,
                            wall_mode, nsw)


def project_stream_masked(vx, vy, vz, fluid_i, acc: int = 15,
                          wall_mode: str = "reference", nsw: int = ls.NSW):
    """The obstacle-scene form of ``project_stream``; ``fluid_i`` is an
    interior-shaped mask (a view of a padded one is fine)."""
    if not _build.on_card(vx):
        return project_stream_masked_plain(vx, vy, vz, fluid_i, acc,
                                           wall_mode, nsw)
    return _project_on_card("project_stream_masked", vx, vy, vz, fluid_i,
                            acc, wall_mode, nsw)


def _project_on_card(name, vx, vy, vz, fluid_i, acc, wall_mode, nsw):
    _build.check_operands(name, (vx, vy, vz), (None, vx.shape, vx.shape))
    if vx.ndim != 3 or min(vx.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(vx.shape)}")
    if nsw not in ls.KERNEL_NSW:
        raise ValueError(f"{name}: nsw={nsw}; the pass kernel takes "
                         f"{ls.KERNEL_NSW}")
    interior = tuple(n - 2 for n in vx.shape)
    if fluid_i is not None:
        _build.mask_view(name, fluid_i, interior, vx.get_device())
    rhs = vx.new_empty(interior)
    _launch_div(vx, vy, vz, fluid_i, rhs)
    fpre = ls.passes(torch.zeros_like(rhs), rhs, fluid_i, 0, 1.0, 6.0, acc,
                     nsw, wall_mode)
    out = vx.new_empty((3,) + interior)
    _launch_grad(vx, vy, vz, fpre, fluid_i, out)
    LAUNCHES[name] += 1
    return out


def divergence_packed(vx, vy, vz, fluid_i=None):
    """Stage 1 alone (``div_packed``), uncounted: the plain version for a
    CPU tensor, the kernel for a CUDA tensor. ``chip_smoke.py`` holds the
    two against each other."""
    if not _build.on_card(vx):
        return divergence_plain(vx, vy, vz, fluid_i)
    _build.check_operands("div_packed", (vx, vy, vz))
    rhs = vx.new_empty(tuple(n - 2 for n in vx.shape))
    _launch_div(vx, vy, vz, fluid_i, rhs)
    return rhs


def gradient_packed(vx, vy, vz, fpre, fluid_i=None):
    """Stage 3 alone (``grad_packed``), uncounted, as ``divergence_packed``."""
    if not _build.on_card(vx):
        return gradient_packed_plain(vx, vy, vz, fpre, fluid_i)
    _build.check_operands("grad_packed", (vx, vy, vz, fpre))
    out = vx.new_empty((3,) + tuple(fpre.shape))
    _launch_grad(vx, vy, vz, fpre, fluid_i, out)
    return out


def _mask(name, fluid_i, shape, device):
    return ((None, 0, 0) if fluid_i is None
            else _build.mask_view(name, fluid_i, shape, device))


def _launch_div(vx, vy, vz, fluid_i, rhs):
    D, H, W = rhs.shape
    ptr, dev = _build.ptr, vx.get_device()
    fl = _mask("div_packed", fluid_i, (D, H, W), dev)
    nhh = float(_coefficients(vx.shape)[0])
    _build.launch("fst_div_packed", dev, ptr(vx), ptr(vy), ptr(vz), *fl,
                  ptr(rhs), D, H, W, nhh)


def _launch_grad(vx, vy, vz, fpre, fluid_i, out):
    D, H, W = fpre.shape
    ptr, dev = _build.ptr, vx.get_device()
    fl = _mask("grad_packed", fluid_i, (D, H, W), dev)
    _, inv_h, inv_2h = (float(x) for x in _coefficients(vx.shape))
    _build.launch("fst_grad_packed", dev, ptr(vx), ptr(vy), ptr(vz),
                  ptr(fpre), *fl, ptr(out), D, H, W, inv_h, inv_2h)
