"""Kernel 2 and kernel 6: the pressure projection (``csrc/project.cu`` plus
``csrc/rbgs.cu``'s half-sweep) and its plain torch version, for an empty
scene and for an obstacle scene.

- ``project_empty`` ports
  ``fluid_simulation_tpu/kernels/project_pallas.py::pallas_project_empty``:
  divergence scaled by ``-0.5h``, ``p = 0``, ``acc`` red-black sweeps with
  ``a=1, c=6``, central/one-sided gradient subtraction, velocity faces.
- ``project_masked`` ports ``pallas_project_masked``: the divergence over
  fluid neighbours times ``fluid_i``, the sweeps with keep = ``fluid_i``,
  the 0/1-mask gradient times ``fluid_i``, the faces from the pre-keep
  edge, then ``keep_vel`` on the interior.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.linsolve import sweeps
from fluid_simulation_tpu_torch.ops.bounds import face_signs, write_faces_
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar, relax
from fluid_simulation_tpu_torch.ops.project import _one_axis_gradient, grid_h


def _coefficients(shape):
    D, H, W = (n - 2 for n in shape)
    h = np.float32(grid_h(W, H, D))
    return (np.float32(-0.5) * h, np.float32(1.0) / h,
            np.float32(1.0) / (np.float32(2.0) * h))


def in_bounds(shape, device):
    """The six in-bounds neighbour tests of a padded ``shape``'s interior,
    broadcastable booleans (x+, x-, y+, y-, z+, z-)."""
    D, H, W = (n - 2 for n in shape)
    ix = torch.arange(W, device=device).reshape(1, 1, W)
    iy = torch.arange(H, device=device).reshape(1, H, 1)
    iz = torch.arange(D, device=device).reshape(D, 1, 1)
    return (ix < W - 1, ix > 0, iy < H - 1, iy > 0, iz < D - 1, iz > 0)


def neighbour_masks(fl):
    """nb_* (x+, x-, y+, y-, z+, z-) of an interior fluid mask: a neighbour
    counts where it is fluid and in the interior (fl padded with a zero
    shell, shifted)."""
    flp = F.pad(fl, (1, 1, 1, 1, 1, 1))
    return (flp[1:-1, 1:-1, 2:], flp[1:-1, 1:-1, :-2], flp[1:-1, 2:, 1:-1],
            flp[1:-1, :-2, 1:-1], flp[2:, 1:-1, 1:-1], flp[:-2, 1:-1, 1:-1])


def divergence_plain(vx, vy, vz, fl=None):
    """The interior rhs of the Poisson solve, ``-0.5h * div``: in-bounds
    selects in an empty scene, the fluid-neighbour masks times ``fl`` (the
    interior fluid mask) in an obstacle scene."""
    nhh = as_scalar(_coefficients(vx.shape)[0], vx.dtype)
    if fl is None:
        xp, xm, yp, ym, zp, zm = in_bounds(vx.shape, vx.device)
        div_val = (torch.where(xp, vx[1:-1, 1:-1, 2:], 0.0)
                   - torch.where(xm, vx[1:-1, 1:-1, :-2], 0.0)
                   + torch.where(yp, vy[1:-1, 2:, 1:-1], 0.0)
                   - torch.where(ym, vy[1:-1, :-2, 1:-1], 0.0)
                   + torch.where(zp, vz[2:, 1:-1, 1:-1], 0.0)
                   - torch.where(zm, vz[:-2, 1:-1, 1:-1], 0.0))
        return nhh * div_val
    nb_xp, nb_xm, nb_yp, nb_ym, nb_zp, nb_zm = neighbour_masks(fl)
    div_val = (vx[1:-1, 1:-1, 2:] * nb_xp - vx[1:-1, 1:-1, :-2] * nb_xm
               + vy[1:-1, 2:, 1:-1] * nb_yp - vy[1:-1, :-2, 1:-1] * nb_ym
               + vz[2:, 1:-1, 1:-1] * nb_zp - vz[:-2, 1:-1, 1:-1] * nb_zm)
    return nhh * div_val * fl


def select_gradients(p):
    """(gx, gy, gz) of padded ``p`` over the interior with the empty scene's
    selects: central where both neighbours are in the interior, one-sided
    where one is, zero where none is (out-of-interior values of ``p`` are
    read but never selected)."""
    _, inv_h, inv_2h = (as_scalar(x, p.dtype) for x in _coefficients(p.shape))
    xp, xm, yp, ym, zp, zm = in_bounds(p.shape, p.device)
    p_i = p[1:-1, 1:-1, 1:-1]

    def grad(has_p, has_m, p_p, p_m):
        return torch.where(
            has_p & has_m, (p_p - p_m) * inv_2h,
            torch.where(has_p, (p_p - p_i) * inv_h,
                        torch.where(has_m, (p_i - p_m) * inv_h, 0.0)))

    return (grad(xp, xm, p[1:-1, 1:-1, 2:], p[1:-1, 1:-1, :-2]),
            grad(yp, ym, p[1:-1, 2:, 1:-1], p[1:-1, :-2, 1:-1]),
            grad(zp, zm, p[2:, 1:-1, 1:-1], p[:-2, 1:-1, 1:-1]))


def masked_gradients(p, fl):
    """(gx, gy, gz) of padded ``p`` over the interior in the obstacle
    scene's 0/1 mask algebra (``ops.project._one_axis_gradient``), with the
    fluid-neighbour masks of the interior fluid mask ``fl``."""
    D, H, W = (n - 2 for n in p.shape)
    h = grid_h(W, H, D)
    nb_xp, nb_xm, nb_yp, nb_ym, nb_zp, nb_zm = neighbour_masks(fl)
    return (
        _one_axis_gradient(p, nb_xp, nb_xm, lambda q: q[1:-1, 1:-1, 2:],
                           lambda q: q[1:-1, 1:-1, :-2], h, p.dtype),
        _one_axis_gradient(p, nb_yp, nb_ym, lambda q: q[1:-1, 2:, 1:-1],
                           lambda q: q[1:-1, :-2, 1:-1], h, p.dtype),
        _one_axis_gradient(p, nb_zp, nb_zm, lambda q: q[2:, 1:-1, 1:-1],
                           lambda q: q[:-2, 1:-1, 1:-1], h, p.dtype))


def project_empty_plain(vx, vy, vz, acc: int = 15,
                        wall_mode: str = "reference"):
    """The projection in plain torch, with the in-bounds selects of the TPU
    kernel (equal in value to ``ops.project.project`` on an empty scene,
    whose 0/1 mask products differ at most in the sign of a zero)."""
    rhs = torch.zeros_like(vx)
    rhs[1:-1, 1:-1, 1:-1] = divergence_plain(vx, vy, vz)
    p = relax(0, torch.zeros_like(vx), rhs, 1.0, 6.0, None, acc=acc,
              solver="rbgs", wall_mode=wall_mode)
    outs = []
    for b, v, g in zip((1, 2, 3), (vx, vy, vz), select_gradients(p)):
        v = v.clone()
        v[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1] - g
        outs.append(write_faces_(v, b, wall_mode))
    return tuple(outs)


def project_empty(vx, vy, vz, acc: int = 15, wall_mode: str = "reference"):
    """Project padded (vx, vy, vz) of an empty scene; returns three new
    tensors. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels or raises."""
    if not _build.on_card(vx):
        return project_empty_plain(vx, vy, vz, acc, wall_mode)
    _build.check_operands("project_empty", (vx, vy, vz),
                          (None, vx.shape, vx.shape))
    if vx.ndim != 3 or min(vx.shape) < 3:
        raise ValueError(f"project_empty: bad padded shape {tuple(vx.shape)}")
    outs = tuple(v.clone() for v in (vx, vy, vz))
    rhs = torch.empty_like(vx)     # only its interior is written and read
    p = torch.zeros_like(vx)
    _launch(*outs, rhs, p, acc, wall_mode)
    LAUNCHES["project_empty"] += 1
    return outs


def _masks(wall_mode):
    """(velocity face-sign mask, pressure face-sign mask, 1/6 in f32)."""
    return (_build.neg_mask([face_signs(b, wall_mode) for b in (1, 2, 3)]),
            _build.neg_mask([face_signs(0, wall_mode)]),
            float(np.float32(1.0) / np.float32(6.0)))


def _launch(vx, vy, vz, rhs, p, acc, wall_mode):
    """Divergence, 2*acc half-sweeps on ``p``, gradient + faces, in place on
    the wrapper's own buffers."""
    D, H, W = (n - 2 for n in vx.shape)
    nhh, inv_h, inv_2h = (float(x) for x in _coefficients(vx.shape))
    vmask, pmask, crec = _masks(wall_mode)
    ptr, dev = _build.ptr, vx.get_device()
    _build.launch("fst_divergence", dev, ptr(vx), ptr(vy), ptr(vz), ptr(rhs),
                  D, H, W, nhh)
    sweeps(p, rhs, 1.0, crec, acc, pmask, None, dev)
    _build.launch("fst_grad_faces", dev, ptr(vx), ptr(vy), ptr(vz), ptr(p),
                  D, H, W, inv_h, inv_2h, vmask)


def project_masked_plain(vx, vy, vz, fluid_i, keep_vel_i, acc: int = 15,
                         wall_mode: str = "reference"):
    """The obstacle-scene projection in plain torch, in the TPU kernel's
    arithmetic form (equal in value to ``ops.project.project`` with
    ``empty_scene=False``). ``fluid_i`` and ``keep_vel_i`` are interior
    masks (``masks.fluid_i``, ``masks.keep_vel[1:-1, 1:-1, 1:-1]``)."""
    dtype = vx.dtype
    fl = fluid_i.to(dtype)
    rhs = torch.zeros_like(vx)
    rhs[1:-1, 1:-1, 1:-1] = divergence_plain(vx, vy, vz, fl)
    # the scalar keep is fluid_i inside and 1 on the ghost shell
    keep_s = F.pad(fl, (1, 1, 1, 1, 1, 1), value=1.0)
    p = relax(0, torch.zeros_like(vx), rhs, 1.0, 6.0, keep_s, acc=acc,
              solver="rbgs", wall_mode=wall_mode)
    outs = []
    for b, v, g in zip((1, 2, 3), (vx, vy, vz), masked_gradients(p, fl)):
        v = v.clone()
        v[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1] - g * fl
        write_faces_(v, b, wall_mode)     # faces from the pre-keep edge
        v[1:-1, 1:-1, 1:-1] *= keep_vel_i.to(dtype)
        outs.append(v)
    return tuple(outs)


def project_masked(vx, vy, vz, fluid_i, keep_vel_i, acc: int = 15,
                   wall_mode: str = "reference"):
    """Project padded (vx, vy, vz) of an obstacle scene; returns three new
    tensors. ``fluid_i`` and ``keep_vel_i`` are interior-shaped masks (a
    view of a padded mask is fine). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernels or raises."""
    if not _build.on_card(vx):
        return project_masked_plain(vx, vy, vz, fluid_i, keep_vel_i, acc,
                                    wall_mode)
    _build.check_operands("project_masked", (vx, vy, vz),
                          (None, vx.shape, vx.shape))
    if vx.ndim != 3 or min(vx.shape) < 3:
        raise ValueError(f"project_masked: bad padded shape {tuple(vx.shape)}")
    interior = tuple(n - 2 for n in vx.shape)
    for m in (fluid_i, keep_vel_i):
        _build.mask_view("project_masked", m, interior, vx.get_device())
    outs = tuple(v.clone() for v in (vx, vy, vz))
    rhs = torch.empty_like(vx)     # only its interior is written and read
    p = torch.zeros_like(vx)
    _launch_masked(*outs, rhs, p, fluid_i, keep_vel_i, acc, wall_mode)
    LAUNCHES["project_masked"] += 1
    return outs


def _launch_masked(vx, vy, vz, rhs, p, fluid_i, keep_vel_i, acc, wall_mode):
    """Masked divergence, the keep-form half-sweeps on ``p`` with keep =
    ``fluid_i`` and the red keep multiply, then the masked gradient + faces
    + keep_vel, in place on the wrapper's own buffers."""
    D, H, W = (n - 2 for n in vx.shape)
    nhh, inv_h, inv_2h = (float(x) for x in _coefficients(vx.shape))
    vmask, pmask, crec = _masks(wall_mode)
    ptr, dev = _build.ptr, vx.get_device()
    fl = _build.mask_view("project_masked", fluid_i, (D, H, W), dev)
    kv = _build.mask_view("project_masked", keep_vel_i, (D, H, W), dev)
    _build.launch("fst_divergence_masked", dev, ptr(vx), ptr(vy), ptr(vz),
                  *fl, ptr(rhs), D, H, W, nhh)
    sweeps(p, rhs, 1.0, crec, acc, pmask, fluid_i, dev)
    _build.launch("fst_grad_faces_masked", dev, ptr(vx), ptr(vy), ptr(vz),
                  ptr(p), *fl, *kv, D, H, W, inv_h, inv_2h, vmask)
