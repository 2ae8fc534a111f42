"""ROADMAP B23: the DMA-issue probe's kernel (``csrc/dma.cu``), one z-blocked
windowed stream with two loaders, and its plain torch version.

Port of the kernel bodies of ``tools/exp_dma.py`` over a (D, H, W) f32 or
bf16 array in z-blocks of ``blk`` planes, with ``hb`` = 2 halo planes:

- ``copy2`` (:98): ``o = a + b``;
- ``copy2h`` (:108): ``o = (a + b) + (alo[0] + ahi[0])``, where ``alo[0]``
  and ``ahi[0]`` are the first planes of ``a``'s lo and hi windows of the
  cell's z-block (``hbm.window_planes``, the index maps at :83-93), and the
  kernel also streams the windows' other planes and ``b``'s windows, as the
  tool's BlockSpecs do. It associates as the tool does (:105-106), not as
  ``hbm.stream_copy``'s ``((a + b) + alo) + ahi``;
- ``manual2`` (:154): ``o = a + b`` out of one merged (blk + 2hb)-plane
  window per operand (D % blk == 0 only).

The loader is the Hopper form of the tool's question, whether time follows
DMA issues or bytes: ``ldg`` streams with per-thread vector loads (copy2,
copy2h), ``tma`` with one ``cp.async.bulk.tensor`` box per window per
operand (copy2: 2, copy2h: 6), and ``manual2`` with one merged box per
operand, double-buffered over the z-blocks a block walks. TMA needs W to
be a multiple of 4 in f32 and of 8 in bf16; a form or shape the kernel
does not take raises ``ValueError`` on every device, never a fallback to
the plain version or to the other loader.

In bf16 every add rounds to bf16, as torch rounds it. The probe that times
it is ``fluid_simulation_tpu_torch/tools/exp_dma.py``; no route of the
wind tunnel calls it.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.hbm import window_planes

HB = 2                           # the tool's halo depth (exp_dma.py:46)
FORMS = ("copy2", "copy2h", "manual2")
LOADERS = ("ldg", "tma")
DTYPES = (torch.float32, torch.bfloat16)
TMA_ROW_BYTES = 256              # a box row of dma.cu: 64 f32, 128 bf16
TMA_ROWS = 8
SMEM_LIMIT = 232448 - 64         # shared memory a block may take, less static


def loaders(form: str):
    """The loaders the kernel has for ``form``: manual2 is TMA only."""
    return ("tma",) if form == "manual2" else LOADERS


def check_form(a: torch.Tensor, form: str, blk: int, loader: str,
               hb: int = HB) -> None:
    """Raise ``ValueError`` unless the kernel takes ``form`` with
    ``loader`` on ``a``'s shape and type (on every device, so the CPU
    refuses what the card would)."""
    if form not in FORMS:
        raise ValueError(f"dma_stream: form {form!r}, expected one of "
                         f"{FORMS}")
    if loader not in loaders(form):
        raise ValueError(f"dma_stream: {form} has no {loader!r} loader; it "
                         f"takes {loaders(form)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"dma_stream: {a.dtype}; the kernel takes float32 "
                         f"and bfloat16")
    if a.ndim != 3 or a.numel() == 0:
        raise ValueError(f"dma_stream: bad (D, H, W) shape {tuple(a.shape)}")
    if blk < 1 or hb < 1 or blk % hb:
        raise ValueError(f"dma_stream: hb={hb} must divide blk={blk}")
    D, H, W = a.shape
    esize = a.element_size()
    if loader == "tma" and W * esize % 16:
        raise ValueError(f"dma_stream: TMA needs 16-byte rows; W={W} is not "
                         f"a multiple of {16 // esize} in {a.dtype}")
    E = blk + 2 * hb
    planes = 4 * E if form == "manual2" else 2 * blk + 4 * hb
    if loader == "tma" and planes * TMA_ROW_BYTES * TMA_ROWS + 128 > \
            SMEM_LIMIT:
        raise ValueError(f"dma_stream: blk={blk} needs more shared memory "
                         f"than a block may take")
    if form == "manual2" and (D % blk or D < E):
        raise ValueError(f"dma_stream: manual2 needs D % blk == 0 and D >= "
                         f"blk + 2hb; D={D}, blk={blk}")


def dma_stream_plain(a: torch.Tensor, b: torch.Tensor, *, form: str,
                     blk: int, loader: str = "tma",
                     hb: int = HB) -> torch.Tensor:
    """The form's function in plain torch, each add rounded to the type."""
    check_form(a, form, blk, loader, hb)
    if form != "copy2h":
        return a + b
    lo, hi = window_planes(a.shape[0], blk, hb, a.device)
    return (a + b) + (a[lo] + a[hi])


def dma_stream(a: torch.Tensor, b: torch.Tensor, *, form: str, blk: int,
               loader: str = "tma", hb: int = HB) -> torch.Tensor:
    """The stream of ``a`` and ``b`` as a new (D, H, W) tensor. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (one launch)
    or raises."""
    check_form(a, form, blk, loader, hb)
    if not _build.on_card(a):
        return dma_stream_plain(a, b, form=form, blk=blk, loader=loader,
                                hb=hb)
    name = "dma_stream"
    _build.check_operands(name, (a, b), (None, a.shape), dtypes=DTYPES)
    if b.dtype != a.dtype:
        raise ValueError(f"dma_stream: operands of {a.dtype} and {b.dtype}")
    if any(t.data_ptr() % 16 for t in (a, b)):
        raise ValueError("dma_stream: operands must be 16-byte aligned")
    out = torch.empty_like(a)
    _launch(a, b, out, form, blk, loader, hb)
    LAUNCHES[name] += 1
    return out


def manual_walk(shape, blk: int, hb: int, esize: int, sms: int) -> int:
    """z-blocks each manual2 block walks: the whole column of its tile
    unless the tiles alone fill fewer blocks than the card holds at once
    (``sms`` times the blocks of this shared-memory size per SM)."""
    D, H, W = shape
    tiles = -(-W // (TMA_ROW_BYTES // esize)) * -(-H // TMA_ROWS)
    smem = 4 * (blk + 2 * hb) * TMA_ROW_BYTES * TMA_ROWS + 128
    resident = sms * max(1, SMEM_LIMIT // smem)
    nblk = D // blk
    chunks = min(nblk, max(1, resident // tiles))
    return -(-nblk // chunks)


def _launch(a, b, out, form, blk, loader, hb):
    D, H, W = a.shape
    esize = a.element_size()
    vec = 16 // esize if W % (16 // esize) == 0 else 1
    walk = 1
    if form == "manual2":
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        walk = manual_walk(a.shape, blk, hb, esize, sms)
    _build.launch("fst_dma_stream", a.get_device(), _build.ptr(a),
                  _build.ptr(b), _build.ptr(out), D, H, W,
                  int(a.dtype == torch.bfloat16), FORMS.index(form),
                  int(loader == "tma"), blk, hb, walk, vec)
