"""Kernel 1: the red-black Gauss-Seidel solve (``csrc/rbgs.cu``) and its plain
torch version.

Port of ``fluid_simulation_tpu/kernels/linsolve_pallas.py::pallas_rbgs_solve``
(``packed=True``, empty scene): ``acc`` red-black sweeps of
``f = (prev + a*sum6(f)) * (1/c)`` with setBounds after every sweep.
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
    tensor. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. ``keep`` (an obstacle scene) has no kernel yet."""
    if not _build.on_card(field):
        return rbgs_solve_plain(b, field, prev, a, c, acc, wall_mode, keep)
    if keep is not None:
        raise NotImplementedError(
            "rbgs_solve with an obstacle keep mask is not ported to the card "
            "yet (ROADMAP B5)")
    _build.check_operands("rbgs_solve", (field, prev),
                          (None, field.shape))
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"rbgs_solve: bad padded shape {tuple(field.shape)}")
    out = field.clone()
    _launch(out, prev, b, a, c, acc, wall_mode)
    LAUNCHES["rbgs_solve"] += 1
    return out


def _launch(out, prev, b, a, c, acc, wall_mode):
    """2*acc half-sweep launches, in place on ``out`` (the wrapper's clone)."""
    D, H, W = (n - 2 for n in out.shape)
    a32 = float(np.float32(a))
    crec = float(np.float32(1.0) / np.float32(c))
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    with torch.cuda.device(out.device):
        stream = _build.stream(out)
        for _ in range(acc):
            for color in (0, 1):
                _build.call("fst_rbgs_half", _build.ptr(out), _build.ptr(prev),
                            D, H, W, a32, crec, color, mask, stream)
