"""ROADMAP B22a: the fused pre-advection block (``csrc/prestep.cu``) and its
plain torch version.

Port of ``tools/prestep_pallas.py::pallas_prestep``: the step's three
velocity diffusions, each with ``prev`` = the component's own input (in the
step, diffusion's rhs is the pre-diffusion field, simulation.cpp:107-117),
then the pressure projection, empty or masked, in one call. On the card it
is one cooperative launch in place of the chain K1 x3 + K2 (K1 keep x3 +
K6), bitwise equal to it. No route of the step calls it, as in the JAX
package, which retired its ``_prestep_applicable`` route
(``tools/exp_prestep_ab.py:1-7``); it is a library function.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.linsolve import (
    _coeffs, rbgs_solve_plain)
from fluid_simulation_tpu_torch.kernels.project import (
    _coefficients, _masks, project_empty_plain, project_masked_plain)


def prestep_supported(shape, dtype=torch.float32, masked: bool = False
                      ) -> bool:
    """Can the kernel run padded ``shape``? float32 and a 3-D shape with
    every side >= 4. The cooperative grid is sized from the card's
    occupancy and walks any grid with grid-stride loops, so every such
    shape's grid is co-resident, with or without the masks (``masked``,
    kept for the JAX gate's signature, changes nothing here); a card that
    refuses the cooperative launch raises at launch."""
    return dtype == torch.float32 and len(shape) == 3 and min(shape) >= 4


def prestep_plain(vx, vy, vz, fluid_i: Optional[torch.Tensor],
                  keep_vel_i: Optional[torch.Tensor], a: float, c: float,
                  acc: int = 15, wall_mode: str = "reference"):
    """The chain the kernel replaces, in plain torch: the diffusions of
    b = 1, 2, 3 with ``prev`` = the input component (``rbgs_solve_plain``,
    the relaxation ``ops.linsolve.diffuse`` runs, with the padded keep_vel
    in an obstacle scene), then the plain projection (``project_empty_plain``
    or ``project_masked_plain``, equal in value to ``ops.project.project``).
    Returns three new tensors."""
    keep = None if fluid_i is None else F.pad(
        keep_vel_i.to(vx.dtype), (1, 1, 1, 1, 1, 1), value=1.0)
    w = [rbgs_solve_plain(b, v, v, a, c, acc, wall_mode, keep)
         for b, v in zip((1, 2, 3), (vx, vy, vz))]
    if fluid_i is None:
        return project_empty_plain(*w, acc, wall_mode)
    return project_masked_plain(*w, fluid_i, keep_vel_i, acc, wall_mode)


def prestep(vx, vy, vz, fluid_i: Optional[torch.Tensor],
            keep_vel_i: Optional[torch.Tensor], a: float, c: float,
            acc: int = 15, wall_mode: str = "reference"):
    """diffuse(1..3) + project of padded ``(vx, vy, vz)``; returns three new
    tensors and leaves the inputs as they are. ``fluid_i`` and
    ``keep_vel_i`` are the interior masks (views of padded masks are fine),
    both None for an empty scene. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one cooperative launch) or raises,
    outside ``prestep_supported`` too."""
    if (fluid_i is None) != (keep_vel_i is None):
        raise ValueError("prestep: give both fluid_i and keep_vel_i, or "
                         "neither (an empty scene)")
    if not _build.on_card(vx):
        return prestep_plain(vx, vy, vz, fluid_i, keep_vel_i, a, c, acc,
                             wall_mode)
    name = "prestep" if fluid_i is None else "prestep_masked"
    _build.check_operands(name, (vx, vy, vz), (None, vx.shape, vx.shape))
    if not prestep_supported(vx.shape, vx.dtype, fluid_i is not None):
        raise ValueError(f"{name}: padded shape {tuple(vx.shape)} is outside "
                         f"the kernel's gate (3-D, every side >= 4)")
    if fluid_i is not None:
        for m in (fluid_i, keep_vel_i):
            _build.mask_view(name, m, [n - 2 for n in vx.shape], vx.get_device())
    outs = tuple(torch.empty_like(vx) for _ in range(3))
    rhs = torch.empty_like(vx)     # only its interior is written and read
    p = torch.empty_like(vx)       # zeroed by the kernel
    _launch(vx, vy, vz, outs, rhs, p, fluid_i, keep_vel_i, a, c, acc,
            wall_mode)
    LAUNCHES[name] += 1
    return outs


def _launch(vx, vy, vz, outs, rhs, p, fluid_i, keep_vel_i, a, c, acc,
            wall_mode):
    """The cooperative launch: ``outs`` get the result, ``rhs`` and ``p``
    are scratch."""
    D, H, W = (n - 2 for n in vx.shape)
    a32, crec = _coeffs(a, c)
    nhh, inv_h, inv_2h = (float(x) for x in _coefficients(vx.shape))
    vmask, pmask, prec = _masks(wall_mode)
    ptr, dev = _build.ptr, vx.get_device()
    fl = kv = (None, 0, 0)
    if fluid_i is not None:
        fl = _build.mask_view("prestep_masked", fluid_i, (D, H, W), dev)
        kv = _build.mask_view("prestep_masked", keep_vel_i, (D, H, W), dev)
    _build.launch("fst_prestep", dev, ptr(vx), ptr(vy), ptr(vz),
                  *map(ptr, outs), ptr(rhs), ptr(p), *fl, *kv, D, H, W, acc,
                  a32, crec, prec, nhh, inv_h, inv_2h, vmask, pmask)


def grid_blocks(device) -> int:
    """Blocks of 256 threads in the kernel's cooperative grid on ``device``:
    every block the card holds at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.call("fst_prestep_blocks", ctypes.addressof(blocks))
    return blocks.value
