"""Kernel 1: the red-black Gauss-Seidel solve (``csrc/rbgs.cu``) and its plain
torch version.

Port of ``fluid_simulation_tpu/kernels/linsolve_pallas.py::pallas_rbgs_solve``
(``packed=True``): ``acc`` red-black sweeps of
``f = (prev + a*sum6(f)) * (1/c)`` with setBounds after every sweep, and in
obstacle scenes (``keep`` given, the ``apply_keep`` branch) the keep
multiply after the faces. Also its two variants:

- ``packed=False`` (``_make_kernel``): the keep multiplies the whole padded
  field after every sweep, ghosts included. The packed form assumes keep is
  1 on the ghost shell, as every mask from ``scene.masks`` is; there the two
  agree. No route of the step takes the unpacked form, as in the JAX
  package (``ops/linsolve.py:79-81`` passes ``packed=True``).
- ``rbgs_solve3`` (``pallas_rbgs_solve3``): three fields with one ``a``,
  ``c`` and keep in one solve, each half-sweep one launch for all three.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import relax


def rbgs_solve_plain(b: int, field: torch.Tensor, prev: torch.Tensor,
                     a: float, c: float, acc: int = 15,
                     wall_mode: str = "reference",
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The solve in plain torch (``ops.linsolve.relax`` with rbgs). It
    multiplies the whole padded field by ``keep``: the unpacked semantics,
    equal to the packed ones wherever keep is 1 on the ghost shell."""
    return relax(b, field, prev, a, c, keep, acc=acc, solver="rbgs",
                 wall_mode=wall_mode)


def rbgs_solve(b: int, field: torch.Tensor, prev: torch.Tensor, a: float,
               c: float, acc: int = 15, wall_mode: str = "reference",
               keep: Optional[torch.Tensor] = None,
               packed: bool = True) -> torch.Tensor:
    """Solve on padded ``field`` with right-hand side ``prev``; returns a new
    tensor. ``keep`` is the padded obstacle multiplier of an obstacle scene
    (``masks.keep_vel`` for b = 1..3, ``masks.keep_scalar`` for b = 0). With
    ``packed`` (every caller in the package) it must be 1 on the ghost
    shell, as every mask from ``scene.masks`` is, and only its interior is
    read; ``packed=False`` applies all of it, ghosts included (without a
    keep the two forms are one). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if not _build.on_card(field):
        return rbgs_solve_plain(b, field, prev, a, c, acc, wall_mode, keep)
    name = ("rbgs_solve" if keep is None else
            "rbgs_solve_keep" if packed else "rbgs_solve_unpacked")
    _build.check_operands(name, (field, prev), (None, field.shape))
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    out = field.clone()
    if keep is not None and not packed:
        _build.check_operands(name, (keep,), (field.shape,))
        _launch_unpacked(out, prev, b, a, c, acc, wall_mode, keep)
    else:
        if keep is not None:
            keep = keep[1:-1, 1:-1, 1:-1]
            _build.mask_view(name, keep, [n - 2 for n in field.shape],
                             field.get_device())
        _launch(out, prev, b, a, c, acc, wall_mode, keep)
    LAUNCHES[name] += 1
    return out


def _coeffs(a, c):
    """``a`` and ``1/c`` rounded to f32, as ``relax`` rounds them."""
    return float(np.float32(a)), float(np.float32(1.0) / np.float32(c))


def _launch(out, prev, b, a, c, acc, wall_mode, keep=None):
    """2*acc half-sweep launches, in place on ``out`` (the wrapper's clone),
    and with ``keep`` (an interior view) the final red keep multiply."""
    a32, crec = _coeffs(a, c)
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    sweeps(out, prev, a32, crec, acc, mask, keep, out.get_device())


def _launch_unpacked(out, prev, b, a, c, acc, wall_mode, keep):
    """The unpacked form in place on ``out``: 2*acc half-sweeps with the
    padded ``keep``, the deferred red keep multiply, and one launch for the
    ghost edges and corners."""
    D, H, W = (n - 2 for n in out.shape)
    a32, crec = _coeffs(a, c)
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    ptr, dev = _build.ptr, out.get_device()
    for _ in range(acc):
        for color in (0, 1):
            _build.launch("fst_rbgs_half_unpacked", dev, ptr(out), ptr(prev),
                          ptr(keep), D, H, W, a32, crec, color, mask)
    if acc:
        kp, ksz, ksy = _build.mask_view(
            "rbgs_solve_unpacked", keep[1:-1, 1:-1, 1:-1], (D, H, W), dev)
        _build.launch("fst_keep_red", dev, ptr(out), kp, ksz, ksy, D, H, W)
        _build.launch("fst_keep_edges", dev, ptr(out), ptr(keep), D, H, W,
                      acc)


def sweeps(f, prev, a32, crec, acc, neg_mask, keep, dev):
    """The half-sweep launches on padded ``f`` in place, on CUDA device
    ``dev`` (an index); with ``keep``, an interior-shaped mask, the keep
    form and the final red multiply. The masked projection runs its Poisson
    solve through here too."""
    D, H, W = (n - 2 for n in f.shape)
    ptr = _build.ptr
    if keep is None:
        for _ in range(acc):
            for color in (0, 1):
                _build.launch("fst_rbgs_half", dev, ptr(f), ptr(prev), D, H,
                              W, a32, crec, color, neg_mask)
        return
    kp, ksz, ksy = _build.mask_view("rbgs_solve_keep", keep, (D, H, W), dev)
    for _ in range(acc):
        for color in (0, 1):
            _build.launch("fst_rbgs_half_keep", dev, ptr(f), ptr(prev), kp,
                          ksz, ksy, D, H, W, a32, crec, color, neg_mask)
    if acc:
        _build.launch("fst_keep_red", dev, ptr(f), kp, ksz, ksy, D, H, W)


def rbgs_solve3_plain(bs: Sequence[int], f1, f2, f3, p1, p2, p3, a: float,
                      c: float, acc: int = 15, wall_mode: str = "reference",
                      keep: Optional[torch.Tensor] = None):
    """Three plain solves, one per field: (out1, out2, out3)."""
    return tuple(rbgs_solve_plain(b, f, p, a, c, acc, wall_mode, keep)
                 for b, f, p in zip(bs, (f1, f2, f3), (p1, p2, p3)))


def rbgs_solve3(bs: Sequence[int], f1, f2, f3, p1, p2, p3, a: float,
                c: float, acc: int = 15, wall_mode: str = "reference",
                keep: Optional[torch.Tensor] = None):
    """Three independent packed solves of field types ``bs`` with one
    ``a``/``c`` and one shared padded ``keep`` (1 on the ghost shell):
    ``(out1, out2, out3)``, each bitwise the single-field solve. The step's
    three velocity diffusions in one call. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one launch per half-sweep
    for all three fields) or raises."""
    fields, prevs = (f1, f2, f3), (p1, p2, p3)
    if not _build.on_card(f1):
        return rbgs_solve3_plain(bs, *fields, *prevs, a, c, acc, wall_mode,
                                 keep)
    if len(bs) != 3:
        raise ValueError(f"rbgs_solve3: three field types, got {bs}")
    if f1.ndim != 3 or min(f1.shape) < 3:
        raise ValueError(f"rbgs_solve3: bad padded shape {tuple(f1.shape)}")
    _build.check_operands("rbgs_solve3", fields + prevs, (f1.shape,) * 6)
    if keep is not None:
        keep = keep[1:-1, 1:-1, 1:-1]
        _build.mask_view("rbgs_solve3", keep, [n - 2 for n in f1.shape],
                         f1.get_device())
    outs = tuple(f.clone() for f in fields)
    _launch3(outs, prevs, bs, a, c, acc, wall_mode, keep)
    LAUNCHES["rbgs_solve3"] += 1
    return outs


def _launch3(outs, prevs, bs, a, c, acc, wall_mode, keep=None):
    """2*acc three-field half-sweeps in place on ``outs``, and with
    ``keep`` (an interior view) the final red keep multiply."""
    D, H, W = (n - 2 for n in outs[0].shape)
    a32, crec = _coeffs(a, c)
    mask = _build.neg_mask([face_signs(b, wall_mode) for b in bs])
    dev = outs[0].get_device()
    kp, ksz, ksy = None, 0, 0
    if keep is not None:
        kp, ksz, ksy = _build.mask_view("rbgs_solve3", keep, (D, H, W), dev)
    fp = [_build.ptr(t) for t in outs]
    pp = [_build.ptr(t) for t in prevs]
    for _ in range(acc):
        for color in (0, 1):
            _build.launch("fst_rbgs_half3", dev, *fp, *pp, kp, ksz, ksy, D, H,
                          W, a32, crec, color, mask)
    if acc and kp is not None:
        _build.launch("fst_keep_red3", dev, *fp, kp, ksz, ksy, D, H, W)
