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
copy2h), ``tma`` with ``cp.async.bulk.tensor`` boxes (copy2: one per
operand per plane; copy2h: one per window per operand, 6), and
``manual2`` with one merged box per operand, double-buffered over the
z-blocks a block walks. copy2's two kernels take one work item
(``copy2_items``) a block, so their work is the same at every blk. The
tensor maps are encoded once per (pointer, shape, type, box) and cached
(``map_key``). TMA needs W to be a multiple
of 4 in f32 and of 8 in bf16; a form or shape the kernel does not take
raises ``ValueError`` on every device, never a fallback to the plain
version or to the other loader.

In bf16 every add rounds to bf16, as torch rounds it. The probe that times
it is ``fluid_simulation_tpu_torch/tools/exp_dma.py``; no route of the
wind tunnel calls it.
"""

from __future__ import annotations

import ctypes
import functools

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
# copy2's work items (dma.cu's Items): planes of a TMA item and of an ldg
# item, whose loads a thread issues together; an ldg block is 32 x 8
# threads of VEC elements
TMA_GROUP = 1
LDG_PLANES, LDG_TILE = 4, (32, 8)
MAP_BYTES = 128                  # sizeof(CUtensorMap)
MAP_CACHE = 256                  # tensor maps kept, least recently used out


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
    if loader == "tma" and tma_smem(form, blk, hb) > SMEM_LIMIT:
        raise ValueError(f"dma_stream: blk={blk} needs more shared memory "
                         f"than a block may take")
    E = blk + 2 * hb
    if form == "manual2" and (D % blk or D < E):
        raise ValueError(f"dma_stream: manual2 needs D % blk == 0 and D >= "
                         f"blk + 2hb; D={D}, blk={blk}")


def tma_smem(form: str, blk: int, hb: int = HB) -> int:
    """Shared memory of a TMA block of ``form``, alignment slack included
    (dma.cu's ``*_smem``): copy2's one ``TMA_GROUP``-plane box per
    operand, whatever blk is; copy2h's six windows; manual2's two slots of
    two merged windows."""
    planes = {"copy2": 2 * TMA_GROUP, "copy2h": 2 * blk + 4 * hb,
              "manual2": 4 * (blk + 2 * hb)}[form]
    return planes * TMA_ROW_BYTES * TMA_ROWS + 128


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
    """The stream of ``a`` and ``b`` as a new (D, H, W) tensor. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (one
    launch) or raises."""
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
    resident = sms * max(1, SMEM_LIMIT // tma_smem("manual2", blk, hb))
    nblk = D // blk
    chunks = min(nblk, max(1, resident // tiles))
    return -(-nblk // chunks)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ldg_vec(W: int, esize: int) -> int:
    """Elements an ldg thread moves a plane: 16 bytes' worth where W is a
    multiple of it, else 1 (the ragged shapes)."""
    return 16 // esize if W % (16 // esize) == 0 else 1


def copy2_items(shape, blk: int, loader: str, esize: int) -> int:
    """copy2's work items on a (D, H, W) array, as dma.cu's ``Items``
    counts them: plane groups (``TMA_GROUP`` or ``LDG_PLANES`` planes, none
    across a z-block's end) of each z-block of each (x, y) tile. copy2's
    grid has one block an item."""
    D, H, W = shape
    if loader == "tma":
        tx, ty, group = TMA_ROW_BYTES // esize, TMA_ROWS, TMA_GROUP
    else:
        tx, ty, group = LDG_TILE[0] * ldg_vec(W, esize), LDG_TILE[1], \
            LDG_PLANES
    tiles = _cdiv(W, tx) * _cdiv(H, ty)
    return tiles * _cdiv(D, blk) * _cdiv(blk, group)


def map_planes(form: str, blk: int, hb: int = HB):
    """The TMA boxes' depths in planes, (mid, halo): copy2's item,
    copy2h's mid and halo windows, manual2's merged window; ``halo`` None
    where the form has no halo map."""
    return {"copy2": (TMA_GROUP, None), "copy2h": (blk, hb),
            "manual2": (blk + 2 * hb, None)}[form]


def map_key(t: torch.Tensor, planes: int) -> tuple:
    """What a tensor map encodes, and so what it is cached under: the
    device, the data pointer, the (D, H, W) shape, the type and the box's
    planes (a contiguous operand's strides follow from its shape). Two
    tensors alive at once never share a pointer, so never a map; a tensor
    allocated where a freed one lay, with its shape and type, has the same
    map."""
    return (t.get_device(), t.data_ptr(), tuple(t.shape), t.dtype, planes)


@functools.lru_cache(maxsize=MAP_CACHE)
def _encoded(device, pointer, shape, dtype, planes):
    buf = ctypes.create_string_buffer(MAP_BYTES)
    D, H, W = shape
    with torch.cuda.device(device):
        _build.call("fst_dma_encode", ctypes.addressof(buf), pointer,
                    int(dtype == torch.bfloat16), D, H, W, planes)
    return buf


def tensor_map(t: torch.Tensor, planes) -> int | None:
    """The address of ``t``'s cached tensor map with boxes of ``planes``
    planes (None for None); the launch copies it into the kernel's
    parameters."""
    if planes is None:
        return None
    return ctypes.addressof(_encoded(*map_key(t, planes)))


def _launch(a, b, out, form, blk, loader, hb):
    D, H, W = a.shape
    esize = a.element_size()
    dev = a.get_device()
    bf16, tma = int(a.dtype == torch.bfloat16), int(loader == "tma")
    vec = ldg_vec(W, esize)
    walk = grid = 1
    if form == "copy2":
        grid = copy2_items(a.shape, blk, loader, esize)
    elif form == "manual2":
        walk = manual_walk(a.shape, blk, hb, esize, _build.sm_count(dev))
    maps = [None] * 4
    if tma:
        mid, halo = map_planes(form, blk, hb)
        maps = [tensor_map(a, mid), tensor_map(a, halo), tensor_map(b, mid),
                tensor_map(b, halo)]
    _build.launch("fst_dma_stream", dev, _build.ptr(a), _build.ptr(b),
                  _build.ptr(out), *maps, D, H, W, bf16, FORMS.index(form),
                  tma, blk, hb, walk, vec, grid)
