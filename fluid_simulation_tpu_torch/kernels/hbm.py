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

The kernel's grid is one block a work item (``stream_items``): ``ITEM``
planes of one z-block of one (x, y) tile. ``item_plan`` says which planes
each item streams and which window planes it stages, as ``csrc/hbm.cu``
deals them out; the CPU tests hold the plan to the tools' window bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar

HB = 8            # the JAX tools' halo window depth (exp_hbm.py:32)
CHAIN_STEPS = 14  # exp_hbm.py:132-133
CHAIN_MUL = 1.0001
ITEM = 4          # planes of a work item (csrc/hbm.cu kGroup)
TILE = (32, 8)    # threads of a block in x and y, VEC cells each in x


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


def stream_vec(a: torch.Tensor, *others) -> int:
    """Cells a thread streams in x: 4 (one 16-byte vector) where W is a
    multiple of 4 and every pointer is 16-byte aligned, else 1."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (a,) + others
                  if t is not None)
    return 4 if a.shape[-1] % 4 == 0 and aligned else 1


def stream_items(shape, blk: int, vec: int) -> int:
    """The kernel's work items on a (D, H, W) array, one block each: groups
    of ``ITEM`` planes (none across a z-block's end) of each z-block of each
    tile of ``TILE[0] * vec`` x ``TILE[1]`` cells."""
    D, H, W = shape
    tiles = -(-W // (TILE[0] * vec)) * -(-H // TILE[1])
    return tiles * -(-D // blk) * -(-blk // ITEM)


def item_plan(D: int, blk: int, hb: int = HB):
    """Per z-block k, its items' work as ``csrc/hbm.cu`` does it, one (x,
    y) tile alike: a list of ``(planes, staged, lohi)`` per item g, where
    ``planes`` are the output planes it streams, ``staged`` the window
    planes it stages (``("a" | "b", z)``, entries g, g + items, .. of
    b(zw), a(zw+1), b(zw+1), .. over the lo then the hi window) and
    ``lohi`` a's planes lo and hi, which it reads for every output."""
    lo, hi = window_planes(D, blk, hb)
    groups = -(-blk // ITEM)
    plan = []
    for k in range(-(-D // blk)):
        zl, zh = int(lo[k * blk]), int(hi[k * blk])
        entries = []
        for zw in (zl, zh):
            for z in range(zw, min(zw + hb, D)):
                if z > zw:
                    entries.append(("a", z))
                entries.append(("b", z))
        items = []
        for g in range(groups):
            z0 = k * blk + g * ITEM
            n = min(ITEM, blk - g * ITEM, D - z0)
            items.append((list(range(z0, z0 + max(n, 0))),
                          entries[g::groups], (zl, zh)))
        plan.append(items)
    return plan


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
    vec = stream_vec(a, out, b)
    _build.launch("fst_hbm_stream", a.get_device(), _build.ptr(a),
                  None if b is None else _build.ptr(b), _build.ptr(out), D, H,
                  W, blk, hb, int(halo), int(chain), vec,
                  stream_items(a.shape, blk, vec))
