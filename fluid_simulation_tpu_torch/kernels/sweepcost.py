"""ROADMAP B23: the sweep-cost variants of the streamed pass kernel
(``csrc/sweepcost.cu`` on ``csrc/rbgs_tile.cuh``) and their plain torch
versions.

Port of the kernel of ``tools/exp_sweepcost.py`` (``make`` :53), which
degraded the TPU's packed 1-sweep stream kernel one mechanism at a time to
split its time. Here the same is done to the port's empty-scene pass
(``kernels/linsolve_stream.sweep_pass``, ``rbgs_pass<nsw>``) at nsw 1 and
2. ``VARIANTS`` in order; ``csrc/sweepcost.cu`` maps each onto the TPU's:

- ``full``: the production pass (``linsolve_stream.pass_plain``);
- ``nosel``: no domain-edge splice: the pass with zero ghost faces;
- ``noiota``: no per-update domain test; the same function as ``full``;
- ``noroll``: the x and y neighbours are the cell itself;
- ``nozn``: the z neighbours are the cell itself;
- ``arith``: no neighbours and no colours: each cell ``2*nsw`` times
  ``u = (rhs + a*(6*u)) * (1/c)``;
- ``coalesced``: nothing removed; the plane loads of the keep forms
  (consecutive cells a warp, by ``cp.async``) in place of a quad a thread,
  so that its time against ``full`` says what those loads give the empty
  pass. The same function as ``full``.

Only ``full``, ``noiota`` and ``coalesced`` compute the solve; the others
are wrong by design, and each is held to its own plain version. The probe
that times them is ``fluid_simulation_tpu_torch/tools/exp_sweepcost.py``;
no route of the wind tunnel calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    KERNEL_NSW, _consts, _mirror_faces_, pass_plain)
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.scene.masks import red_parity

VARIANTS = ("full", "nosel", "noiota", "noroll", "nozn", "arith",
            "coalesced")


def _check(variant: str, nsw: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"sweepcost_pass: unknown variant {variant!r}; "
                         f"one of {VARIANTS}")
    if nsw not in KERNEL_NSW:
        raise ValueError(f"sweepcost_pass: nsw={nsw}; the pass kernel takes "
                         f"{KERNEL_NSW}")


def _sum(f, variant):
    """The neighbour sum of padded ``f``'s interior, left-associated as
    ``ops.linsolve.neighbor_sum``, with the variant's neighbours replaced by
    the cell itself."""
    c = f[1:-1, 1:-1, 1:-1]
    xp, xm = f[1:-1, 1:-1, 2:], f[1:-1, 1:-1, :-2]
    yp, ym = f[1:-1, 2:, 1:-1], f[1:-1, :-2, 1:-1]
    zp, zm = f[2:, 1:-1, 1:-1], f[:-2, 1:-1, 1:-1]
    if variant == "noroll":
        xp = xm = yp = ym = c
    if variant == "nozn":
        zp = zm = c
    return ((((xp + xm) + yp) + ym) + zp) + zm


def sweep_pass_variant_plain(fpre, rhs_i, variant: str, nsw: int, b: int,
                             a: float, c: float,
                             wall_mode: str = "reference"):
    """One empty-scene pass of ``nsw`` sweeps of the carry ``fpre`` with
    ``variant``'s mechanisms removed, in plain torch (module docstring)."""
    _check(variant, nsw)
    if variant in ("full", "noiota", "coalesced"):
        return pass_plain(fpre, rhs_i, None, b, a, c, nsw, wall_mode)
    a, crec = _consts(a, c, fpre.dtype)
    if variant == "arith":
        for _ in range(2 * nsw):
            fpre = (rhs_i + a * (6.0 * fpre)) * crec
        return fpre
    red = red_parity(fpre.shape, fpre.device)
    for _ in range(nsw):
        f = F.pad(fpre, (1, 1) * 3)
        if variant != "nosel":
            _mirror_faces_(f, fpre, b, wall_mode)
        interior = f[1:-1, 1:-1, 1:-1]
        upd = lambda: (rhs_i + a * _sum(f, variant)) * crec   # noqa: E731
        interior.copy_(torch.where(red, upd(), interior))
        interior.copy_(torch.where(red, interior, upd()))
        fpre = interior.contiguous()
    return fpre


def sweep_pass_variant(fpre, rhs_i, variant: str, nsw: int, b: int,
                       a: float, c: float, wall_mode: str = "reference"):
    """One pass of ``variant`` as a new packed tensor. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (one launch) or
    raises."""
    _check(variant, nsw)
    if not _build.on_card(fpre):
        return sweep_pass_variant_plain(fpre, rhs_i, variant, nsw, b, a, c,
                                        wall_mode)
    name = "sweepcost_pass"
    _build.check_operands(name, (fpre,))
    if fpre.ndim != 3 or fpre.numel() == 0:
        raise ValueError(f"{name}: bad (D, H, W) shape {tuple(fpre.shape)}")
    out = torch.empty_like(fpre)
    _launch(fpre, rhs_i, out, variant, nsw, b, a, c, wall_mode)
    LAUNCHES[name] += 1
    return out


def _launch(fin, rhs_i, out, variant, nsw, b, a, c, wall_mode):
    D, H, W = fin.shape
    dev = fin.get_device()
    rp, rsz, rsy = _build.mask_view("sweepcost_pass", rhs_i, (D, H, W), dev)
    a32, crec = (float(x) for x in _consts(a, c, torch.float32))
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    _build.launch("fst_sweepcost_pass", dev, _build.ptr(fin), rp, rsz, rsy,
                  _build.ptr(out), D, H, W, a32, crec, nsw, mask,
                  VARIANTS.index(variant))
