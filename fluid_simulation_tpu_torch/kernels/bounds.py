"""Kernel 4: padded fields with setBounds faces from advected interiors
(``csrc/pad_bounds.cu``) and its plain torch version.

Port of ``fluid_simulation_tpu/kernels/bounds_pallas.py::pallas_pad_bounds``,
unmasked and masked (``fluid_i``/``keep_i``, obstacle scenes). Per field
with tag ``b``: interior = the sample (times ``fluid_i`` and the
keep mask in obstacle scenes), each ghost face = the signed mirror of the
pre-keep interior edge (x+ a plain copy), ghost edges and corners zero —
``set_bounds(b, zeros.at[interior].set(sample))``.

The kernel's work item is a padded (z, y) row of every field of the stack,
one warp each: a lane carries several x positions and loads them in every
field (and, masked, both masks once for all fields) before it stores. What
bounds it is HBM traffic, the interiors and masks read once and the padded
fields written once: on an H100 a three-field call at 512x256x256 runs at
88 % of that bound, 91 % masked (PERF.md, K7; ``csrc/pad_bounds.cu`` gives
the design).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs


def pad_bounds_plain(smp: torch.Tensor, bs: Sequence[int],
                     wall_mode: str = "reference",
                     fluid_i: Optional[torch.Tensor] = None,
                     keep_i: Optional[torch.Tensor] = None):
    """The concat form of the JAX package's ``_pad_bounds_tail``
    (``models/windtunnel.py:157-177``); returns a tuple of padded fields."""
    if smp.ndim == 3:
        smp = smp[None]
    outs = []
    for i, b in enumerate(bs):
        iv = smp[i] if fluid_i is None else smp[i] * fluid_i
        core = iv if keep_i is None else iv * keep_i
        sx, sy, sz = face_signs(b, wall_mode)
        lvl1 = torch.cat([sx * iv[:, :, :1], core, iv[:, :, -1:]], dim=2)
        zc = iv.new_zeros((iv.shape[0], 1, 1))
        fy0 = torch.cat([zc, sy * iv[:, :1, :], zc], dim=2)
        fy1 = torch.cat([zc, sy * iv[:, -1:, :], zc], dim=2)
        lvl2 = torch.cat([fy0, lvl1, fy1], dim=1)
        fz0 = F.pad(sz * iv[:1], (1, 1, 1, 1))
        fz1 = F.pad(sz * iv[-1:], (1, 1, 1, 1))
        outs.append(torch.cat([fz0, lvl2, fz1], dim=0))
    return tuple(outs)


def pad_bounds(smp: torch.Tensor, bs: Sequence[int],
               wall_mode: str = "reference",
               fluid_i: Optional[torch.Tensor] = None,
               keep_i: Optional[torch.Tensor] = None):
    """Padded fields from interiors ``smp`` (B, D, H, W) or (D, H, W), one per
    tag in ``bs``; obstacle scenes pass both interior masks ``fluid_i`` and
    ``keep_i`` (a view of a padded mask is fine). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises. On the card
    the fields are views of one (B, D+2, H+2, W+2) allocation."""
    if not _build.on_card(smp):
        return pad_bounds_plain(smp, bs, wall_mode, fluid_i, keep_i)
    masked = fluid_i is not None or keep_i is not None
    name = "pad_bounds_masked" if masked else "pad_bounds"
    if masked and (fluid_i is None or keep_i is None):
        raise ValueError(f"{name}: give both fluid_i and keep_i, or neither")
    if smp.ndim == 3:
        smp = smp[None]
    if smp.ndim != 4 or smp.shape[0] != len(bs) or min(smp.shape[1:]) < 1:
        raise ValueError(f"{name}: {tuple(smp.shape)} vs bs={tuple(bs)}")
    _build.check_operands(name, (smp,))
    B, D, H, W = smp.shape
    if masked:
        for m in (fluid_i, keep_i):
            _build.mask_view(name, m, (D, H, W), smp.get_device())
    out = torch.empty((B, D + 2, H + 2, W + 2), dtype=smp.dtype,
                      device=smp.device)
    _launch(smp, out, bs, wall_mode, fluid_i, keep_i)
    LAUNCHES[name] += 1
    return tuple(out.unbind(0))


def _launch(smp, out, bs, wall_mode, fluid_i=None, keep_i=None):
    B, D, H, W = smp.shape
    mask = _build.neg_mask([face_signs(b, wall_mode) for b in bs])
    ptr, dev = _build.ptr, smp.get_device()
    if fluid_i is None:
        _build.launch("fst_pad_bounds", dev, ptr(smp), ptr(out), B, D, H, W,
                      mask)
        return
    fl, kp = (_build.mask_view("pad_bounds_masked", m, (D, H, W), dev)
              for m in (fluid_i, keep_i))
    _build.launch("fst_pad_bounds_masked", dev, ptr(smp), ptr(out), *fl, *kp,
                  B, D, H, W, mask)
