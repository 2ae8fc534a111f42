"""Kernels 11-13: the streamed, temporally blocked red-black Gauss-Seidel solve
of big grids (``csrc/rbgs_stream.cu``) and its plain torch version.

Port of the JAX package's big-grid solves, which compute one map on the
packed (D, H, W) pre-keep carry ``fpre``: ``pallas_rbgs_solve_mdma``
(``kernels/linsolve_mdma.py``), ``pallas_rbgs_solve_stream`` and
``pallas_rbgs_solve_stream_t`` (``kernels/linsolve_stream.py``), and
``pallas_rbgs_solve_temporal`` (``kernels/linsolve_temporal.py``, the same
function in the padded layout). A solve is

1. sweep 1 on the padded field, which reads the caller's own ghost faces
   and writes no face and no keep: the packed pre-keep field after one
   sweep (``make_sweep1_packed_call``);
2. ``(acc - 1) // nsw`` passes of ``nsw`` sweeps on the carry, then one
   pass of the remainder (``merged_sweep_chain``). Inside a pass an
   out-of-domain neighbour reads ``sign * fpre`` of the edge cell itself
   (x+ an outflow copy), the red half reads black cells times keep and the
   black half reads the red cells' fresh pre-keep values;
3. the padded result (``_rebuild_padded``): interior ``fpre * keep``, faces
   the signed mirrors of the pre-keep edge, ghost edges and corners passed
   through from the input. Plain torch glue on the card too.

This equals ``ops.linsolve.relax`` with rbgs (the resident route,
``kernels/linsolve.py``) bit for bit. The plain version repeats the carry
algebra step by step and does not call ``relax``.

The route. Grids of ``STREAM_MIN_CELLS`` interior cells or more stream their
solves and projections; smaller ones stay on the resident kernels. The
constant sits between the 128x64x64 class (524,288 cells, whose padded field
and rhs, 4.5 MB, live in the H100's 50 MB L2 across the 30 half-sweeps of a
solve) and 256x128x128 (4,194,304 cells, 35 MB for the pair, 137 MB per
field at 512x256x256), where the JAX package's own gates split them at the
bench's grids. ``NSW`` = 2 sweeps per pass, as ``linsolve_mdma.mdma_params``
fixes it by measurement on the TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar, neighbor_sum
from fluid_simulation_tpu_torch.scene.masks import red_parity

STREAM_MIN_CELLS = 1 << 22
NSW = 2
KERNEL_NSW = (1, 2)   # the pass depths the card's kernel is built for


def streams(shape) -> bool:
    """True when a padded field of ``shape`` takes the streamed solve and
    projection (at least ``STREAM_MIN_CELLS`` interior cells)."""
    D, H, W = (n - 2 for n in shape)
    return D * H * W >= STREAM_MIN_CELLS


def _chain(one_pass, fpre, n_sweeps: int, nsw: int):
    """``n_sweeps`` sweeps as passes of ``nsw`` plus one remainder pass;
    ``one_pass(fpre, depth)`` runs one pass."""
    npass, rem = divmod(n_sweeps, nsw)
    for _ in range(npass):
        fpre = one_pass(fpre, nsw)
    if rem:
        fpre = one_pass(fpre, rem)
    return fpre


def _mirror_faces_(f, fpre, b, wall_mode):
    """Write padded ``f``'s six ghost faces as the signed mirrors of the
    pre-keep edges of ``fpre`` (x+ a plain copy); edges and corners stay."""
    sx, sy, sz = face_signs(b, wall_mode)
    f[1:-1, 1:-1, 0] = sx * fpre[:, :, 0]
    f[1:-1, 1:-1, -1] = fpre[:, :, -1]
    f[1:-1, 0, 1:-1] = sy * fpre[:, 0, :]
    f[1:-1, -1, 1:-1] = sy * fpre[:, -1, :]
    f[0, 1:-1, 1:-1] = sz * fpre[0]
    f[-1, 1:-1, 1:-1] = sz * fpre[-1]
    return f


def _sweep_(f, rhs_i, a, crec, red):
    """One red-black sweep of padded ``f``'s interior in place; the ghost
    cells are read, never written."""
    interior = f[1:-1, 1:-1, 1:-1]
    upd = lambda: (rhs_i + a * neighbor_sum(f)) * crec   # noqa: E731
    interior.copy_(torch.where(red, upd(), interior))
    interior.copy_(torch.where(red, interior, upd()))


def _consts(a, c, dtype):
    return (as_scalar(a, dtype),
            as_scalar(np.float32(1.0) / np.float32(c), dtype))


def sweep1_plain(field, rhs_i, a: float, c: float):
    """Sweep 1 in plain torch: the packed pre-keep field after one sweep of
    padded ``field`` (its own ghost faces) with interior rhs ``rhs_i``."""
    f = field.clone()
    _sweep_(f, rhs_i, *_consts(a, c, f.dtype),
            red_parity(rhs_i.shape, f.device))
    return f[1:-1, 1:-1, 1:-1].contiguous()


def pass_plain(fpre, rhs_i, keep_i: Optional[torch.Tensor], b: int, a: float,
               c: float, nsw: int, wall_mode: str = "reference"):
    """One pass in plain torch: the pre-keep carry ``nsw`` sweeps later.
    Each sweep reads a padded array whose interior is ``fpre * keep_i`` and
    whose faces are ``sign * fpre`` at the edge."""
    a, crec = _consts(a, c, fpre.dtype)
    red = red_parity(fpre.shape, fpre.device)
    for _ in range(nsw):
        f = F.pad(fpre if keep_i is None else fpre * keep_i, (1, 1) * 3)
        _mirror_faces_(f, fpre, b, wall_mode)
        _sweep_(f, rhs_i, a, crec, red)
        fpre = f[1:-1, 1:-1, 1:-1].contiguous()
    return fpre


def passes_plain(fpre, rhs_i, keep_i, b, a, c, n_sweeps, nsw, wall_mode):
    """``n_sweeps`` sweeps of the carry as plain passes of ``nsw``."""
    return _chain(lambda f, n: pass_plain(f, rhs_i, keep_i, b, a, c, n,
                                          wall_mode), fpre, n_sweeps, nsw)


def rebuild_padded(field, fpre, keep_i: Optional[torch.Tensor], b: int,
                   wall_mode: str = "reference"):
    """The padded solve result from the final carry: interior ``fpre *
    keep_i``, faces from the pre-keep edge, ghost edges and corners from
    ``field``."""
    out = field.clone()
    out[1:-1, 1:-1, 1:-1] = fpre if keep_i is None else fpre * keep_i
    return _mirror_faces_(out, fpre, b, wall_mode)


def rbgs_solve_stream_plain(b: int, field, prev, a: float, c: float,
                            acc: int = 15, wall_mode: str = "reference",
                            keep: Optional[torch.Tensor] = None,
                            nsw: int = NSW):
    """The streamed solve in plain torch (any ``nsw`` >= 1)."""
    if acc < 1:
        return field.clone()
    keep_i = None if keep is None else keep[1:-1, 1:-1, 1:-1]
    rhs_i = prev[1:-1, 1:-1, 1:-1]
    fpre = passes_plain(sweep1_plain(field, rhs_i, a, c), rhs_i, keep_i, b,
                        a, c, acc - 1, nsw, wall_mode)
    return rebuild_padded(field, fpre, keep_i, b, wall_mode)


def rbgs_solve_stream(b: int, field, prev, a: float, c: float, acc: int = 15,
                      wall_mode: str = "reference",
                      keep: Optional[torch.Tensor] = None, nsw: int = NSW):
    """Solve on padded ``field`` with right-hand side ``prev`` through
    passes of ``nsw`` sweeps; returns a new padded tensor, equal to
    ``kernels.linsolve.rbgs_solve``'s. ``keep`` is the padded obstacle
    multiplier (1 on the ghost shell). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels or raises."""
    if not _build.on_card(field):
        return rbgs_solve_stream_plain(b, field, prev, a, c, acc, wall_mode,
                                       keep, nsw)
    name = "rbgs_solve_stream" if keep is None else "rbgs_solve_stream_keep"
    _build.check_operands(name, (field, prev), (None, field.shape))
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    if nsw not in KERNEL_NSW:
        raise ValueError(f"{name}: nsw={nsw}; the pass kernel takes "
                         f"{KERNEL_NSW}")
    interior = tuple(n - 2 for n in field.shape)
    keep_i = None
    if keep is not None:
        keep_i = keep[1:-1, 1:-1, 1:-1]
        _build.mask_view(name, keep_i, interior, field.get_device())
    if acc < 1:
        return field.clone()
    rhs_i = prev[1:-1, 1:-1, 1:-1]
    fpre = field.new_empty(interior)
    _launch_sweep1(field, rhs_i, fpre, a, c)
    fpre = passes(fpre, rhs_i, keep_i, b, a, c, acc - 1, nsw, wall_mode)
    out = rebuild_padded(field, fpre, keep_i, b, wall_mode)
    LAUNCHES[name] += 1
    return out


def passes(fpre, rhs_i, keep_i, b, a, c, n_sweeps, nsw, wall_mode):
    """``n_sweeps`` sweeps of the carry ``fpre`` (a buffer the caller owns,
    overwritten) as kernel passes, ping-ponging between two buffers; returns
    the buffer that holds the result. The streamed projection runs its
    Poisson solve through here too."""
    spare = torch.empty_like(fpre)

    def one_pass(f, depth):
        nonlocal spare
        _launch_pass(f, rhs_i, keep_i, spare, b, a, c, depth, wall_mode)
        f, spare = spare, f
        return f

    return _chain(one_pass, fpre, n_sweeps, nsw)


def sweep1(field, rhs_i, a: float, c: float):
    """Sweep 1 alone (``rbgs_sweep1``), uncounted: the plain version for a
    CPU tensor, the kernel for a CUDA tensor. ``chip_smoke.py`` holds the
    two against each other."""
    if not _build.on_card(field):
        return sweep1_plain(field, rhs_i, a, c)
    _build.check_operands("rbgs_sweep1", (field,))
    out = field.new_empty(tuple(n - 2 for n in field.shape))
    _launch_sweep1(field, rhs_i, out, a, c)
    return out


def sweep_pass(fpre, rhs_i, keep_i, b: int, a: float, c: float, nsw: int,
               wall_mode: str = "reference"):
    """One pass alone (``rbgs_pass``), uncounted, as ``sweep1``."""
    if not _build.on_card(fpre):
        return pass_plain(fpre, rhs_i, keep_i, b, a, c, nsw, wall_mode)
    _build.check_operands("rbgs_pass", (fpre,))
    out = torch.empty_like(fpre)
    _launch_pass(fpre, rhs_i, keep_i, out, b, a, c, nsw, wall_mode)
    return out


def _launch_sweep1(field, rhs_i, out, a, c):
    D, H, W = out.shape
    dev = field.get_device()
    rp, rsz, rsy = _build.mask_view("rbgs_sweep1", rhs_i, (D, H, W), dev)
    a32, crec = (float(x) for x in _consts(a, c, torch.float32))
    _build.launch("fst_rbgs_sweep1", dev, _build.ptr(field), rp, rsz, rsy,
                  _build.ptr(out), D, H, W, a32, crec)


def _launch_pass(fin, rhs_i, keep_i, out, b, a, c, nsw, wall_mode):
    """One pass of ``nsw`` sweeps from ``fin`` into ``out`` (both packed)."""
    D, H, W = fin.shape
    dev = fin.get_device()
    rp, rsz, rsy = _build.mask_view("rbgs_pass", rhs_i, (D, H, W), dev)
    kp, ksz, ksy = (None, 0, 0) if keep_i is None else _build.mask_view(
        "rbgs_pass", keep_i, (D, H, W), dev)
    a32, crec = (float(x) for x in _consts(a, c, torch.float32))
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    _build.launch("fst_rbgs_pass", dev, _build.ptr(fin), rp, rsz, rsy, kp,
                  ksz, ksy, _build.ptr(out), D, H, W, a32, crec, nsw, mask)
