"""Kernels 15 and 20: one red-black sweep on a sharded z-slab
(``csrc/rbgs_sweep.cu``), and their plain torch versions.

Port of ``fluid_simulation_tpu/kernels/linsolve_sweep.py``. The sharded
solve (``parallel/sharded.py``) interleaves half-sweeps with halo exchanges
between ranks, so the resident solve (kernel 1) cannot run it: one call here
is everything between two exchanges of one sweep on the local slab,

  red half  ->  black half with the black-phase halo planes  ->  x/y faces
  ->  z mirror ghosts  ->  obstacle keep

- ``rbgs_sweep_packed`` (ROADMAP B15, ``pallas_rbgs_sweep_packed``): the
  slab travels as its (Dl, H, W) interior plus explicit ghost planes. This
  is the sharded solve's route on the card.
- ``rbgs_sweep`` (ROADMAP B20, ``pallas_rbgs_sweep``): the same sweep on
  the padded (Dl+2, H+2, W+2) slab. No route takes it, as in the JAX
  package, whose sharded solve calls only the packed kernel.

Red cells are those whose local 0-based ``iz+iy+ix`` is odd (1-based
coordinate sum even); with an even slab depth ``Dl`` that is the global
parity on every rank (``sweep_supported``). The update keeps the reference's
operand order, ``(prev + a*((((x+ + x-) + y+) + y-) + z+) + z-)) * (1/c)``,
so the kernels equal these plain versions bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar, neighbor_sum
from fluid_simulation_tpu_torch.scene.masks import red_parity


def sweep_supported(local_shape, dtype=torch.float32) -> bool:
    """Can the sweep kernels run this local padded slab shape? float32, an
    interior slab depth ``Dl >= 2`` that is even (so local parity is global
    parity), and ``H, W >= 2``. The solver (rbgs) is the caller's gate."""
    if len(local_shape) != 3 or min(local_shape) < 4:
        return False
    return dtype == torch.float32 and (local_shape[0] - 2) % 2 == 0


def _coeffs(a, c, dtype):
    return as_scalar(a, dtype), as_scalar(np.float32(1.0) / np.float32(c),
                                          dtype)


def _half_(f, prev_i, a, crec, sel):
    """One half-sweep in place on padded ``f``: the cells of ``sel``."""
    interior = f[1:-1, 1:-1, 1:-1]
    interior.copy_(torch.where(sel, (prev_i + a * neighbor_sum(f)) * crec,
                               interior))


def rbgs_sweep_packed_plain(b: int, fk, rp, kp, gx0, gx1, gy0, gy1, znlo,
                            znhi, bp_lo, bp_hi, a: float, c: float,
                            wall_mode: str = "reference"):
    """The packed sweep in plain torch. ``fk`` (Dl, H, W) is the post-keep
    field, ``rp``/``kp`` the rhs and keep interiors, ``gx0/gx1`` (Dl, H)
    and ``gy0/gy1`` (Dl, W) the x/y ghost planes, ``znlo/znhi`` (H, W) the
    z neighbours of the red half at local rows -1 and Dl, ``bp_lo/bp_hi``
    those of the black half. Returns ``(fk', gx0', gx1', gy0', gy1', gz0',
    gz1')``: the field times keep, and the next sweep's ghost planes, sign
    times the pre-keep edges (x+ a plain copy)."""
    Dl, H, W = fk.shape
    a, crec = _coeffs(a, c, fk.dtype)
    f = fk.new_zeros((Dl + 2, H + 2, W + 2))
    f[1:-1, 1:-1, 1:-1] = fk
    f[1:-1, 1:-1, 0] = gx0
    f[1:-1, 1:-1, -1] = gx1
    f[1:-1, 0, 1:-1] = gy0
    f[1:-1, -1, 1:-1] = gy1
    f[0, 1:-1, 1:-1] = znlo
    f[-1, 1:-1, 1:-1] = znhi
    red = red_parity((Dl, H, W), fk.device)
    _half_(f, rp, a, crec, red)
    f[0, 1:-1, 1:-1] = bp_lo
    f[-1, 1:-1, 1:-1] = bp_hi
    _half_(f, rp, a, crec, ~red)
    f2 = f[1:-1, 1:-1, 1:-1]
    sx, sy, sz = face_signs(b, wall_mode)
    return (f2 * kp, sx * f2[:, :, 0], f2[:, :, -1].clone(),
            sy * f2[:, 0, :], sy * f2[:, -1, :], sz * f2[0], sz * f2[-1])


def rbgs_sweep_plain(b: int, field, prev, keep, bp_lo, bp_hi, a: float,
                     c: float, wall_mode: str = "reference",
                     apply_keep: bool = True):
    """The padded sweep in plain torch: red half, rows 0 and Dl+1 replaced
    by ``bp_lo``/``bp_hi`` (H+2, W+2), black half, the x/y faces on the
    interior rows, rows 0 and Dl+1 zeroed with the z mirrors ``sz * row``
    in their interior, and with ``apply_keep`` the whole padded slab times
    the padded ``keep``, ghosts included. Returns a new tensor."""
    D2, H2, W2 = field.shape
    a, crec = _coeffs(a, c, field.dtype)
    f = field.clone()
    prev_i = prev[1:-1, 1:-1, 1:-1]
    red = red_parity((D2 - 2, H2 - 2, W2 - 2), field.device)
    _half_(f, prev_i, a, crec, red)
    f[0] = bp_lo
    f[-1] = bp_hi
    _half_(f, prev_i, a, crec, ~red)
    sx, sy, sz = face_signs(b, wall_mode)
    f[1:-1, 1:-1, 0] = sx * f[1:-1, 1:-1, 1]
    f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
    f[1:-1, 0, 1:-1] = sy * f[1:-1, 1, 1:-1]
    f[1:-1, -1, 1:-1] = sy * f[1:-1, -2, 1:-1]
    lo, hi = sz * f[1, 1:-1, 1:-1], sz * f[-2, 1:-1, 1:-1]
    f[0] = 0.0
    f[-1] = 0.0
    f[0, 1:-1, 1:-1] = lo
    f[-1, 1:-1, 1:-1] = hi
    return f * keep if apply_keep else f


def rbgs_sweep_packed(b: int, fk, rp, kp, gx0, gx1, gy0, gy1, znlo, znhi,
                      bp_lo, bp_hi, a: float, c: float,
                      wall_mode: str = "reference"):
    """One packed sweep (``rbgs_sweep_packed_plain`` for the operands);
    returns seven new tensors. ``rp`` and ``kp`` may be interior views of
    padded arrays. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (two launches) or raises."""
    if not _build.on_card(fk):
        return rbgs_sweep_packed_plain(b, fk, rp, kp, gx0, gx1, gy0, gy1,
                                       znlo, znhi, bp_lo, bp_hi, a, c,
                                       wall_mode)
    name = "rbgs_sweep_packed"
    if fk.ndim != 3 or min(fk.shape) < 2:
        raise ValueError(f"{name}: bad interior shape {tuple(fk.shape)}")
    Dl, H, W = fk.shape
    ins = (fk, gx0, gx1, gy0, gy1, znlo, znhi, bp_lo, bp_hi)
    _build.check_operands(name, ins, ((Dl, H, W), (Dl, H), (Dl, H), (Dl, W),
                                      (Dl, W)) + ((H, W),) * 4)
    for m in (rp, kp):
        _build.mask_view(name, m, (Dl, H, W), fk.get_device())
    outs = tuple(torch.empty(s, dtype=fk.dtype, device=fk.device) for s in
                 ((Dl, H, W), (Dl, H), (Dl, H), (Dl, W), (Dl, W), (H, W),
                  (H, W)))
    f1 = torch.empty_like(fk)
    _launch_packed(ins, rp, kp, outs, f1, b, a, c, wall_mode)
    LAUNCHES[name] += 1
    return outs


def rbgs_sweep(b: int, field, prev, keep, bp_lo, bp_hi, a: float, c: float,
               wall_mode: str = "reference", apply_keep: bool = True):
    """One padded sweep (``rbgs_sweep_plain`` for the operands); returns a
    new tensor. ``keep`` is the padded keep, read only with
    ``apply_keep``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (three launches) or raises."""
    if not _build.on_card(field):
        return rbgs_sweep_plain(b, field, prev, keep, bp_lo, bp_hi, a, c,
                                wall_mode, apply_keep)
    name = "rbgs_sweep"
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    plane = field.shape[1:]
    ops = (field, prev, bp_lo, bp_hi) + ((keep,) if apply_keep else ())
    _build.check_operands(name, ops, (None, field.shape, plane, plane,
                                      field.shape))
    out = field.clone()
    _launch_padded(out, prev, keep if apply_keep else None, bp_lo, bp_hi, b,
                   a, c, wall_mode)
    LAUNCHES[name] += 1
    return out


def _launch_packed(ins, rp, kp, outs, f1, b, a, c, wall_mode):
    """The red launch (``fk`` -> ``f1``), then the black launch (``f1`` ->
    the seven outputs)."""
    fk, gx0, gx1, gy0, gy1, znlo, znhi, bp_lo, bp_hi = ins
    Dl, H, W = fk.shape
    a32, crec = _coeffs(a, c, torch.float32)
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    ptr, dev = _build.ptr, fk.get_device()
    rpv = _build.mask_view("rbgs_sweep_packed", rp, (Dl, H, W), dev)
    kpv = _build.mask_view("rbgs_sweep_packed", kp, (Dl, H, W), dev)
    _build.launch("fst_sweep_packed_red", dev, ptr(fk), *rpv, ptr(gx0),
                  ptr(gx1), ptr(gy0), ptr(gy1), ptr(znlo), ptr(znhi),
                  ptr(f1), Dl, H, W, a32, crec)
    _build.launch("fst_sweep_packed_black", dev, ptr(f1), *rpv, *kpv,
                  ptr(gx0), ptr(gx1), ptr(gy0), ptr(gy1), ptr(bp_lo),
                  ptr(bp_hi), *map(ptr, outs), Dl, H, W, a32, crec, mask)


def _launch_padded(out, prev, keep, bp_lo, bp_hi, b, a, c, wall_mode):
    """In place on ``out`` (the wrapper's clone): the red and the black
    half-sweep, each writing its edge cells' faces and z mirrors, then one
    launch that zeroes the borders of rows 0 and Dl+1 and, with ``keep``,
    multiplies the whole slab by it."""
    Dl, H, W = (n - 2 for n in out.shape)
    a32, crec = _coeffs(a, c, torch.float32)
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    ptr, dev = _build.ptr, out.get_device()
    for color in (0, 1):
        _build.launch("fst_sweep_half", dev, ptr(out), ptr(prev), ptr(bp_lo),
                      ptr(bp_hi), Dl, H, W, a32, crec, color, mask)
    _build.launch("fst_sweep_finish", dev, ptr(out),
                  None if keep is None else ptr(keep), Dl, H, W, 1)
