"""ROADMAP B23: the streaming-ceiling probes' kernel (``csrc/hbm.cu``), one
z-blocked windowed stream, and its plain torch version.

Port of the kernel bodies of ``tools/exp_hbm.py`` (``copy1`` :75, ``copy2``
:85, ``copy1b`` :102, ``copy2h`` :112, ``sweepish`` :128) and
``tools/exp_hbm2.py`` (``copy2d`` :78, ``copy2hd`` :88, ``arithd`` :104):
over a (D, H, W) f32 array in z-blocks of ``blk`` planes,

- ``o = a + 1`` (one input);
- ``o = a + b`` (two inputs);
- with ``halo``: ``o = ((a + b) + alo[0]) + ahi[0]``, where ``alo[0]`` and
  ``ahi[0]`` are the first planes of ``a``'s lo and hi windows of ``hb``
  planes for the cell's z-block (``window_planes``), and the kernel also
  streams the windows' other planes and ``b``'s windows, as the JAX tools'
  BlockSpecs do;
- with ``chain`` (and ``halo``): ``acc = a``, 14 times ``acc = acc*1.0001 +
  b``, ``o = (acc + alo[0]) + ahi[0]``.

The probes that time it are ``fluid_simulation_tpu_torch/tools/exp_hbm.py``
and ``exp_hbm2.py``; no route of the wind tunnel calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar

HB = 8            # the JAX tools' halo window depth (exp_hbm.py:32)
CHAIN_STEPS = 14  # exp_hbm.py:132-133
CHAIN_MUL = 1.0001


def _check_form(b, blk: int, halo: bool, chain: bool, hb: int) -> None:
    if blk < 1:
        raise ValueError(f"hbm_stream: blk={blk}; it must be >= 1")
    if halo and b is None:
        raise ValueError("hbm_stream: halo windows need two inputs")
    if halo and (hb < 1 or blk % hb):
        raise ValueError(f"hbm_stream: hb={hb} must divide blk={blk}")
    if chain and not halo:
        raise ValueError("hbm_stream: the chain runs with halo windows only, "
                         "as in the JAX tools")


def window_planes(D: int, blk: int, hb: int = HB, device="cpu"):
    """``(lo, hi)``: for each z plane, the first plane of its z-block's lo
    and hi windows. Block k's windows start at ``hb*max(k*r - 1, 0)`` and
    ``hb*min(k*r + r, nhb - 1)``, r = blk // hb, nhb = ceil(D / hb): the
    BlockSpec index maps of ``tools/exp_hbm2.py:44-49`` (r = 2 there)."""
    k = torch.arange(D, device=device) // blk
    r, nhb = blk // hb, -(-D // hb)
    return (hb * torch.clamp(k * r - 1, min=0),
            hb * torch.clamp(k * r + r, max=nhb - 1))


def stream_copy_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                      blk: int, halo: bool = False, chain: bool = False,
                      hb: int = HB) -> torch.Tensor:
    """The stream's function in plain torch (module docstring), each
    operation rounded on its own."""
    _check_form(b, blk, halo, chain, hb)
    if b is None:
        return a + 1.0
    if not halo:
        return a + b
    lo, hi = window_planes(a.shape[0], blk, hb, a.device)
    v = a
    if chain:
        m = as_scalar(CHAIN_MUL, a.dtype)
        for _ in range(CHAIN_STEPS):
            v = v * m + b
    else:
        v = a + b
    return (v + a[lo]) + a[hi]


def stream_copy(a: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                blk: int, halo: bool = False, chain: bool = False,
                hb: int = HB) -> torch.Tensor:
    """The stream of ``a`` (and ``b``) as a new (D, H, W) tensor. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (one
    launch) or raises."""
    _check_form(b, blk, halo, chain, hb)
    if not _build.on_card(a):
        return stream_copy_plain(a, b, blk=blk, halo=halo, chain=chain,
                                 hb=hb)
    name = "hbm_stream"
    ins = (a,) if b is None else (a, b)
    _build.check_operands(name, ins, (None, a.shape))
    if a.ndim != 3 or a.numel() == 0:
        raise ValueError(f"hbm_stream: bad (D, H, W) shape {tuple(a.shape)}")
    out = torch.empty_like(a)
    _launch(a, b, out, blk, hb, halo, chain)
    LAUNCHES[name] += 1
    return out


def _launch(a, b, out, blk, hb, halo, chain):
    D, H, W = a.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, out)
                  + (() if b is None else (b,)))
    vec = 4 if W % 4 == 0 and aligned else 1
    _build.launch("fst_hbm_stream", a.get_device(), _build.ptr(a),
                  None if b is None else _build.ptr(b), _build.ptr(out), D, H,
                  W, blk, hb, int(halo), int(chain), vec)
