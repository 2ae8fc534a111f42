"""ROADMAP B22b: the colour-packed red-black solve (``csrc/rbgs_cpack.cu``)
and its plain torch version.

Port of ``tools/linsolve_cpack.py``: ``pallas_rbgs_solve_cpack`` (resident)
and ``pallas_rbgs_solve_cpack_stream`` (streamed, for grids past VMEM). Both
run sweep 1 in a padded solve, which honours the caller's ghosts, and
sweeps 2..acc on the two colour halves of the interior (0-based, row
parity ``pr = (1 + z + y) % 2``):

    R[z, y, i] = f[z, y, 2i + pr],    B[z, y, i] = f[z, y, 2i + 1 - pr]

so that each half-sweep updates one whole (D, H, W/2) array with no colour
select. The entry points differ only around those sweeps:

- ``rbgs_solve_cpack``: sweep 1 by the port's K1 with the keep
  (``kernels/linsolve.rbgs_solve``, acc 1); its pre-keep edge values are
  recovered from its ghost faces (ghost = sign * pre); the output is
  rebuilt on sweep 1's.
- ``rbgs_solve_cpack_stream``: sweep 1 by the blocked solve without the
  keep (``kernels/linsolve_blocked.rbgs_solve_blocked``, acc 1), whose
  interior is the pre-keep field itself; the output is rebuilt on
  ``field``.

Both carry the PRE-KEEP halves through the sweeps, as the streamed TPU
kernel does: red reads black as ``B * KB`` (the post-keep black), black
reads red unmasked, and the keep is applied once after the last sweep.
Starting both halves from the pre-keep field differs from the resident TPU
kernel's start only where it reads ``x * k * k`` for ``x * k``, equal for
a 0/1 keep, so one kernel pair serves both. The packing, the edge recovery
and the padded rebuild are torch glue, as they were XLA glue outside the
Pallas kernels. The TPU gates (``W/2 % 128``, the VMEM budget, the z-block
picker) do not apply on the card: any float32 grid with an even interior W
and every interior side >= 2 runs. No route of the step calls either entry
point, as in the JAX package; they are library functions.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.linsolve import (
    _coeffs, rbgs_solve, rbgs_solve_plain)
from fluid_simulation_tpu_torch.kernels.linsolve_blocked import (
    rbgs_solve_blocked, rbgs_solve_blocked_plain)
from fluid_simulation_tpu_torch.ops.bounds import face_signs


def _row_parity0(D: int, H: int, device) -> torch.Tensor:
    """(D, H, 1) bool: the rows with pr == 0, i.e. z + y odd (0-based)."""
    z = torch.arange(D, device=device).reshape(D, 1, 1)
    y = torch.arange(H, device=device).reshape(1, H, 1)
    return (z + y) % 2 == 1


def pack_colors(f_i: torch.Tensor):
    """(D, H, W) interior -> the (R, B) halves, each (D, H, W/2); W even."""
    D, H, _ = f_i.shape
    pr0 = _row_parity0(D, H, f_i.device)
    ev, od = f_i[:, :, 0::2], f_i[:, :, 1::2]
    return torch.where(pr0, ev, od), torch.where(pr0, od, ev)


def unpack_colors(R: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_colors``."""
    D, H, Wh = R.shape
    pr0 = _row_parity0(D, H, R.device)
    ev, od = torch.where(pr0, R, B), torch.where(pr0, B, R)
    return torch.stack([ev, od], dim=-1).reshape(D, H, 2 * Wh)


def cpack_supported(shape, dtype=torch.float32) -> bool:
    """Can the colour-packed solve run padded ``shape``? float32, 3-D, an
    even interior W and every interior side >= 2."""
    return (dtype == torch.float32 and len(shape) == 3 and min(shape) >= 4
            and (shape[2] - 2) % 2 == 0)


def _check(name: str, field, prev, keep, empty_scene: bool) -> None:
    """Raise unless the solve can run: ``NotImplementedError`` for a type
    other than float32, ``ValueError`` for a shape outside
    ``cpack_supported`` or a missing keep, on either device; on the card,
    ``check_operands``' refusals too."""
    if not empty_scene and keep is None:
        raise ValueError(f"{name}: an obstacle scene needs its keep")
    if field.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: {field.dtype} is not ported yet (ROADMAP A11); the "
            f"colour-packed solve takes float32")
    if not cpack_supported(field.shape, field.dtype):
        raise ValueError(f"{name}: padded shape {tuple(field.shape)} needs "
                         f"3 dimensions, an even interior W and every "
                         f"interior side >= 2")
    if _build.on_card(field):
        ops = (field, prev) + (() if empty_scene else (keep,))
        _build.check_operands(name, ops, (None,) + (field.shape,) * 2)


def half_sweep_plain(own, other, kother: Optional[torch.Tensor], prev_h,
                     a: float, crec: float, signs, red: bool):
    """One colour half-sweep in plain torch: the new ``own`` half from the
    ``other`` colour (times ``kother`` where given), the rhs half
    ``prev_h`` and ``own`` itself at the faces (``sign * own``, the x+ face
    a plain copy), in the kernel's order of operations."""
    sx, sy, sz = signs
    D, H, _ = own.shape
    o = other if kother is None else other * kother
    # the opposite colour's second x neighbour is one lane to the left on
    # these rows (red: pr == 0; black: pr == 1), else one to the right
    pr0 = _row_parity0(D, H, own.device)
    left = pr0 if red else ~pr0
    lft = torch.cat([sx * own[:, :, :1], o[:, :, :-1]], dim=2)
    rgt = torch.cat([o[:, :, 1:], own[:, :, -1:]], dim=2)
    xp = torch.where(left, o, rgt)
    xm = torch.where(left, lft, o)
    yp = torch.cat([o[:, 1:], sy * own[:, -1:]], dim=1)
    ym = torch.cat([sy * own[:, :1], o[:, :-1]], dim=1)
    zp = torch.cat([o[1:], sz * own[-1:]], dim=0)
    zm = torch.cat([sz * own[:1], o[:-1]], dim=0)
    s = ((((xp + xm) + yp) + ym) + zp) + zm
    return (prev_h + a * s) * crec


def _sweeps_plain(R, B, PR, PB, KB, a32, crec, signs, nsweep):
    """``nsweep`` sweeps on the pre-keep halves: red, then black."""
    for _ in range(nsweep):
        R = half_sweep_plain(R, B, KB, PR, a32, crec, signs, red=True)
        B = half_sweep_plain(B, R, None, PB, a32, crec, signs, red=False)
    return R, B


def _launch(R, B, PR, PB, KB, a32, crec, signs, nsweep):
    """``nsweep`` sweeps in place on the halves (the wrapper's own
    tensors): two launches each, red then black."""
    D, H, Wh = R.shape
    mask = _build.neg_mask([signs])
    ptr, dev = _build.ptr, R.get_device()
    kb = None if KB is None else ptr(KB)
    for _ in range(nsweep):
        _build.launch("fst_cpack_red", dev, ptr(R), ptr(B), kb, ptr(PR), D, H,
                      Wh, a32, crec, mask)
        _build.launch("fst_cpack_black", dev, ptr(B), ptr(R), ptr(PB), D, H,
                      Wh, a32, crec, mask)
    return R, B


def _edges_pre(f1, signs):
    """Sweep 1's interior with its edge cells set to their pre-keep values,
    read back from the ghost faces (ghost = sign * pre, so pre = sign *
    ghost; the x+ face is a plain copy). Faces in setBounds' order; a cell
    on two faces reads the same value from both."""
    sx, sy, sz = signs
    fpre = f1[1:-1, 1:-1, 1:-1].clone()
    fpre[:, :, 0] = sx * f1[1:-1, 1:-1, 0]
    fpre[:, :, -1] = f1[1:-1, 1:-1, -1]
    fpre[:, 0, :] = sy * f1[1:-1, 0, 1:-1]
    fpre[:, -1, :] = sy * f1[1:-1, -1, 1:-1]
    fpre[0] = sz * f1[0, 1:-1, 1:-1]
    fpre[-1] = sz * f1[-1, 1:-1, 1:-1]
    return fpre


def _finish(out, prev, keep, fpre, a, c, acc, signs, empty_scene, sweeps):
    """Sweeps 2..acc on the halves of the pre-keep interior ``fpre`` by
    ``sweeps``, the keep, and the rebuild in place on padded ``out``:
    interior = pre * keep, faces = signed mirrors of the final pre-keep
    edges; ghost edges and corners stay as ``out`` has them."""
    sx, sy, sz = signs
    a32, crec = _coeffs(a, c)
    R, B = pack_colors(fpre)
    PR, PB = pack_colors(prev[1:-1, 1:-1, 1:-1])
    keep_i = None if empty_scene else keep[1:-1, 1:-1, 1:-1].to(out.dtype)
    KB = None if keep_i is None else pack_colors(keep_i)[1]
    R, B = sweeps(R, B, PR, PB, KB, a32, crec, signs, acc - 1)
    pre = unpack_colors(R, B)
    out[1:-1, 1:-1, 1:-1] = pre if keep_i is None else pre * keep_i
    out[1:-1, 1:-1, 0] = sx * pre[:, :, 0]
    out[1:-1, 1:-1, -1] = pre[:, :, -1]
    out[1:-1, 0, 1:-1] = sy * pre[:, 0, :]
    out[1:-1, -1, 1:-1] = sy * pre[:, -1, :]
    out[0, 1:-1, 1:-1] = sz * pre[0]
    out[-1, 1:-1, 1:-1] = sz * pre[-1]
    return out


def _resident(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
              solve1, sweeps):
    """The resident entry point with sweep 1 by ``solve1`` (K1's form) and
    the half-sweeps by ``sweeps``."""
    if acc < 1:
        return field.clone()
    keep = None if empty_scene else keep
    f1 = solve1(b, field, prev, a, c, 1, wall_mode, keep)
    if acc == 1:
        return f1
    signs = face_signs(b, wall_mode)
    return _finish(f1, prev, keep, _edges_pre(f1, signs), a, c, acc, signs,
                   empty_scene, sweeps)


def _streamed(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
              solve1, sweeps):
    """The streamed entry point with sweep 1 by ``solve1`` (the blocked
    solve's form, run without the keep) and the half-sweeps by
    ``sweeps``."""
    if acc < 1:
        return field.clone()
    pre1 = solve1(b, field, prev, None, a, c, 1, wall_mode, True)
    return _finish(field.clone(), prev, keep, pre1[1:-1, 1:-1, 1:-1], a, c,
                   acc, face_signs(b, wall_mode), empty_scene, sweeps)


def rbgs_solve_cpack_plain(b: int, field, prev, keep: Optional[torch.Tensor],
                           a: float, c: float, acc: int = 15,
                           wall_mode: str = "reference",
                           empty_scene: bool = False) -> torch.Tensor:
    """The resident colour-packed solve in plain torch: sweep 1 by K1's
    plain version, then the plain half-sweeps."""
    _check("rbgs_solve_cpack", field, prev, keep, empty_scene)
    return _resident(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
                     rbgs_solve_plain, _sweeps_plain)


def rbgs_solve_cpack(b: int, field, prev, keep: Optional[torch.Tensor],
                     a: float, c: float, acc: int = 15,
                     wall_mode: str = "reference",
                     empty_scene: bool = False) -> torch.Tensor:
    """Solve on padded ``field`` with right-hand side ``prev`` and the
    padded ``keep`` (1 on the ghost shell; ignored with ``empty_scene``);
    returns a new tensor, equal to K1's ``rbgs_solve``. ``acc < 1`` returns
    a copy of ``field``, ``acc == 1`` sweep 1. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (sweep 1 through K1, which
    counts under its own name, then ``2·(acc − 1)`` half-sweep launches,
    one count per call) or raises."""
    if not _build.on_card(field):
        return rbgs_solve_cpack_plain(b, field, prev, keep, a, c, acc,
                                      wall_mode, empty_scene)
    _check("rbgs_solve_cpack", field, prev, keep, empty_scene)
    out = _resident(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
                    rbgs_solve, _launch)
    if acc > 1:
        LAUNCHES["rbgs_solve_cpack"] += 1
    return out


def rbgs_solve_cpack_stream_plain(b: int, field, prev,
                                  keep: Optional[torch.Tensor], a: float,
                                  c: float, acc: int = 15,
                                  wall_mode: str = "reference",
                                  empty_scene: bool = False) -> torch.Tensor:
    """The streamed colour-packed solve in plain torch: sweep 1 by the
    blocked solve's plain version without the keep, then the plain
    half-sweeps."""
    _check("rbgs_solve_cpack_stream", field, prev, keep, empty_scene)
    return _streamed(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
                     rbgs_solve_blocked_plain, _sweeps_plain)


def rbgs_solve_cpack_stream(b: int, field, prev, keep: Optional[torch.Tensor],
                            a: float, c: float, acc: int = 15,
                            wall_mode: str = "reference",
                            empty_scene: bool = False) -> torch.Tensor:
    """The streamed entry point: as ``rbgs_solve_cpack``, with sweep 1 by
    the blocked solve (one count under ``rbgs_solve_blocked``) and the
    output rebuilt on ``field``; one count per colour-packed sweep,
    ``acc − 1`` per call. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernels or raises."""
    if not _build.on_card(field):
        return rbgs_solve_cpack_stream_plain(b, field, prev, keep, a, c, acc,
                                             wall_mode, empty_scene)
    _check("rbgs_solve_cpack_stream", field, prev, keep, empty_scene)
    out = _streamed(b, field, prev, keep, a, c, acc, wall_mode, empty_scene,
                    rbgs_solve_blocked, _launch)
    LAUNCHES["rbgs_solve_cpack_stream"] += max(acc - 1, 0)
    return out
