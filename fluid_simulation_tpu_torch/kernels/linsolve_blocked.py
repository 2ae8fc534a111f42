"""ROADMAP B22c: the z-blocked red-black solve, ``acc`` full padded sweeps
(``csrc/rbgs_sweep.cu``), and its plain torch version.

Port of ``tools/linsolve_blocked.py::pallas_rbgs_solve_blocked``: per sweep
the red and the black half, the x/y faces on the interior rows, the
interiors of the z faces, then the whole padded field times the padded
``keep`` (none with ``empty_scene``). The TPU kernel streamed z-blocks of
``blk`` rows through VMEM; the card needs no blocks, so there is no ``blk``.
Each sweep is B20's padded half-sweep kernel twice, reading its z
neighbours from the field's own ghost rows, and, with a keep, B20's closing
launch with the borders of the z ghost rows left as they are: B20 zeroes
them, and the blocked sweep (like the plain relaxation) passes them through.
No route of the step calls it, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.linsolve_sweep import _coeffs
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import relax


def rbgs_solve_blocked_plain(b: int, field, prev,
                             keep: Optional[torch.Tensor], a: float, c: float,
                             acc: int = 15, wall_mode: str = "reference",
                             empty_scene: bool = False) -> torch.Tensor:
    """``acc`` plain full sweeps: the port's rbgs relaxation
    (``ops.linsolve.relax``) with the padded ``keep``, or none with
    ``empty_scene``."""
    return relax(b, field, prev, a, c, None if empty_scene else keep,
                 acc=acc, solver="rbgs", wall_mode=wall_mode)


def rbgs_solve_blocked(b: int, field, prev, keep: Optional[torch.Tensor],
                       a: float, c: float, acc: int = 15,
                       wall_mode: str = "reference",
                       empty_scene: bool = False) -> torch.Tensor:
    """Solve on padded ``field`` with right-hand side ``prev`` and the
    padded ``keep`` (read unless ``empty_scene``, ghosts included); returns
    a new tensor. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernels (two or three launches per sweep, one count per
    sweep) or raises."""
    name = "rbgs_solve_blocked"
    if not empty_scene and keep is None:
        raise ValueError(f"{name}: an obstacle scene needs its keep")
    if not _build.on_card(field):
        return rbgs_solve_blocked_plain(b, field, prev, keep, a, c, acc,
                                        wall_mode, empty_scene)
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    ops = (field, prev) + (() if empty_scene else (keep,))
    _build.check_operands(name, ops, (None, field.shape, field.shape))
    out = field.clone()
    _launch(out, prev, None if empty_scene else keep, b, a, c, acc,
            wall_mode)
    LAUNCHES[name] += acc
    return out


def _launch(out, prev, keep, b, a, c, acc, wall_mode):
    """``acc`` sweeps in place on ``out`` (the wrapper's clone): the red and
    the black half-sweep with the z neighbours from ``out``'s own rows 0
    and D+1 (null planes), then with ``keep`` the closing keep launch that
    leaves the z ghost rows' borders as they are."""
    D, H, W = (n - 2 for n in out.shape)
    a32, crec = _coeffs(a, c, torch.float32)
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    ptr, dev = _build.ptr, out.get_device()
    for _ in range(acc):
        for color in (0, 1):
            _build.launch("fst_sweep_half", dev, ptr(out), ptr(prev), None,
                          None, D, H, W, a32, crec, color, mask)
        if keep is not None:
            _build.launch("fst_sweep_finish", dev, ptr(out), ptr(keep), D, H,
                          W, 0)
