"""Kernel 1: the red-black Gauss-Seidel solve (``csrc/rbgs.cu``) and its plain
torch version.

Port of ``fluid_simulation_tpu/kernels/linsolve_pallas.py::pallas_rbgs_solve``
(``packed=True``): ``acc`` red-black sweeps of
``f = (prev + a*sum6(f)) * (1/c)`` with setBounds after every sweep, and in
obstacle scenes (``keep`` given, the ``apply_keep`` branch) the keep
multiply after the faces.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import relax


def rbgs_solve_plain(b: int, field: torch.Tensor, prev: torch.Tensor,
                     a: float, c: float, acc: int = 15,
                     wall_mode: str = "reference",
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The solve in plain torch (``ops.linsolve.relax`` with rbgs)."""
    return relax(b, field, prev, a, c, keep, acc=acc, solver="rbgs",
                 wall_mode=wall_mode)


def rbgs_solve(b: int, field: torch.Tensor, prev: torch.Tensor, a: float,
               c: float, acc: int = 15, wall_mode: str = "reference",
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve on padded ``field`` with right-hand side ``prev``; returns a new
    tensor. ``keep`` is the padded obstacle multiplier of an obstacle scene
    (``masks.keep_vel`` for b = 1..3, ``masks.keep_scalar`` for b = 0), 1 on
    the ghost shell as every mask from ``scene.masks`` is. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if not _build.on_card(field):
        return rbgs_solve_plain(b, field, prev, a, c, acc, wall_mode, keep)
    name = "rbgs_solve" if keep is None else "rbgs_solve_keep"
    _build.check_operands(name, (field, prev), (None, field.shape))
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    if keep is not None:
        keep = keep[1:-1, 1:-1, 1:-1]
        _build.mask_view(name, keep, [n - 2 for n in field.shape],
                         field.device)
    out = field.clone()
    _launch(out, prev, b, a, c, acc, wall_mode, keep)
    LAUNCHES[name] += 1
    return out


def _launch(out, prev, b, a, c, acc, wall_mode, keep=None):
    """2*acc half-sweep launches, in place on ``out`` (the wrapper's clone),
    and with ``keep`` (an interior view) the final red keep multiply."""
    a32 = float(np.float32(a))
    crec = float(np.float32(1.0) / np.float32(c))
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    with torch.cuda.device(out.device):
        sweeps(out, prev, a32, crec, acc, mask, keep, _build.stream(out))


def sweeps(f, prev, a32, crec, acc, neg_mask, keep, stream):
    """The half-sweep launches on padded ``f`` in place; with ``keep``, an
    interior-shaped mask, the keep form and the final red multiply. The
    masked projection runs its Poisson solve through here too."""
    D, H, W = (n - 2 for n in f.shape)
    ptr = _build.ptr
    if keep is None:
        for _ in range(acc):
            for color in (0, 1):
                _build.call("fst_rbgs_half", ptr(f), ptr(prev), D, H, W, a32,
                            crec, color, neg_mask, stream)
        return
    kp, ksz, ksy = _build.mask_view("rbgs_solve_keep", keep, (D, H, W),
                                    f.device)
    for _ in range(acc):
        for color in (0, 1):
            _build.call("fst_rbgs_half_keep", ptr(f), ptr(prev), kp, ksz, ksy,
                        D, H, W, a32, crec, color, neg_mask, stream)
    if acc:
        _build.call("fst_keep_red", ptr(f), kp, ksz, ksy, D, H, W, stream)
