"""ROADMAP B23: the transpose probe's kernels (``csrc/transpose.cu``) and
their plain torch versions.

Port of the kernel bodies of ``tools/exp_transpose.py``, which asked
whether Mosaic could transpose or re-stride values inside a TPU kernel and
at what cost. On the card they are two data movements over strided views:

- ``transpose2d``: the last two axes of an (R, C) or (B, R, C) f32 view
  swapped into a new contiguous (C, R) or (B, C, R) tensor, through a
  32 x 32 shared-memory tile: ``probe``'s ``mk.f`` (:61), ``probe3``'s
  ``major_slice_T`` (:163, on the view ``a[:, 3, :]``), and the boundary
  rows' transposes of the advected stack;
- ``strided_copy``: a view of rank 1 to 3 times ``scale`` into a new
  contiguous tensor of its shape: ``probe3``'s ``swap01`` (:133, on
  ``a.transpose(0, 1)``), ``strided_row`` (:148, ``a[:, 3, :]``) and
  ``store_strided`` (:179, ``a`` times 2). ``copy_plan`` merges the view's
  dims whose strides chain (``collapse``) and picks the kernel: one
  float4 a thread over one aligned contiguous run, float4 rows where x is
  contiguous and 16-byte aligned, one element a thread otherwise.

The probe that times them is ``fluid_simulation_tpu_torch/tools/
exp_transpose.py``; no route of the wind tunnel calls them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build

MAX_BATCH = 65535   # the transpose's batch is the grid's z dimension
# strided_copy: a merged dim's most elements (32-bit indices, rows ahead)
MAX_DIM = 1 << 30
COPY_THREADS = 256          # a block of csrc/transpose.cu's copies
ROWS_AHEAD = 2              # rows a rows-path thread loads at once, at most
GRID_YZ = 65535             # the grid's y and z limit
PATHS = ("rows", "rows4", "flat4")   # fst_strided_copy's path 0, 1, 2
PLAN_CACHE = 1024           # merged layouts and launch plans kept


def transpose2d_plain(x: torch.Tensor) -> torch.Tensor:
    """The last two axes of ``x`` swapped, contiguous, in plain torch."""
    return x.transpose(-1, -2).contiguous()


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """The last two axes of the (R, C) or (B, R, C) view ``x`` swapped into
    a new contiguous tensor. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (one launch) or raises."""
    if x.ndim not in (2, 3) or x.numel() == 0:
        raise ValueError(f"transpose: bad (B, R, C) shape {tuple(x.shape)}")
    if not _build.on_card(x):
        return transpose2d_plain(x)
    v = x if x.ndim == 3 else x[None]
    _check_view("transpose", v)
    B, R, C = v.shape
    if B > MAX_BATCH:
        raise ValueError(f"transpose: batch {B} over {MAX_BATCH}")
    out = torch.empty((B, C, R), dtype=x.dtype, device=x.device)
    _launch_transpose(v, out)
    LAUNCHES["transpose"] += 1
    return out if x.ndim == 3 else out[0]


def strided_copy_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``x * scale`` as a new contiguous tensor, in plain torch."""
    return (x * scale).contiguous()


def strided_copy(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``x * scale`` of the rank 1-3 view ``x`` as a new contiguous tensor
    of its shape. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (one launch) or raises."""
    if not 1 <= x.ndim <= 3 or x.numel() == 0:
        raise ValueError(f"strided_copy: bad shape {tuple(x.shape)}; rank 1 "
                         f"to 3")
    if not _build.on_card(x):
        return strided_copy_plain(x, scale)
    _check_view("strided_copy", x)
    shape, strides = merged(x.shape, x.stride())
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch_copy(x, shape, strides, out, scale)
    LAUNCHES["strided_copy"] += 1
    return out


def collapse(shape, strides):
    """``(shape, strides)`` of the same elements in the same order with
    the fewest dims: dims of size 1 dropped, and each pair of neighbours
    merged where the outer stride is the inner stride times the inner size
    (while the merged size stays within ``MAX_DIM``). At least one dim."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1] or [(1, 1)]
    out = [dims[-1]]
    for n, s in reversed(dims[:-1]):
        n_in, s_in = out[-1]
        if s == s_in * n_in and n * n_in <= MAX_DIM:
            out[-1] = (n * n_in, s_in)
        else:
            out.append((n, s))
    out.reverse()
    return tuple(n for n, _ in out), tuple(s for _, s in out)


@functools.lru_cache(maxsize=PLAN_CACHE)
def merged(shape: tuple, strides: tuple):
    """``(shape, strides)`` of a view's merged dims (``collapse``), padded
    to rank 3 with leading dims of size 1: the elements the kernel reads,
    in the order it writes them. Raises ``ValueError`` where a dim that
    cannot merge is over ``MAX_DIM``."""
    shape, strides = collapse(shape, strides)
    if max(shape) > MAX_DIM:
        raise ValueError(f"strided_copy: a dim of {max(shape)} elements "
                         f"after merging, over {MAX_DIM}")
    pad = 3 - len(shape)
    return ((1,) * pad + shape, (shape[0] * strides[0],) * pad + strides)


def collapsed_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the rank-3 view of its merged dims (``merged``)."""
    return x.as_strided(*merged(x.shape, x.stride()))


class CopyPlan(NamedTuple):
    """``fst_strided_copy``'s launch: the path (``PATHS``), the block
    (bx, by), the grid (gx, gy, gz) and the rows a rows-path thread loads
    at once (``ahead``)."""
    path: str
    block: tuple
    grid: tuple
    ahead: int = 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def copy_plan(shape, strides, offset: int, sms: int = 132) -> CopyPlan:
    """The launch of a rank-3 merged view (``merged``) of
    ``shape`` and element ``strides`` whose first element lies ``offset``
    bytes past a 16-byte boundary, on a card of ``sms`` SMs (the H100's
    132 unless given; only ``ahead`` depends on it). ``flat4``
    where the view is one contiguous, aligned run of a multiple of 4 (one
    float4 a thread); ``rows4`` where x is contiguous (stride 1) in rows of
    a multiple of 4 and every row starts 16-byte aligned; ``rows``
    otherwise. A rows block is 256 threads, as wide as a row's values (a
    power of 2 up to 256) and as many rows tall as that leaves; each thread
    takes ``ROWS_AHEAD`` rows at once, or one where that would leave fewer
    blocks than SMs. Pure, so the CPU tests check it."""
    (n0, n1, n2), (s0, s1, s2) = shape, strides
    aligned = (offset % 16 == 0 and s2 == 1 and n2 % 4 == 0
               and (n0 == 1 or s0 % 4 == 0) and (n1 == 1 or s1 % 4 == 0))
    if aligned and n0 == n1 == 1:
        return CopyPlan("flat4", (COPY_THREADS, 1),
                        (_cdiv(n2 // 4, COPY_THREADS), 1, 1))
    cols = n2 // 4 if aligned else n2
    bx = min(COPY_THREADS, 1 << max(0, cols - 1).bit_length())
    by = COPY_THREADS // bx

    def grid(ahead):
        return (_cdiv(cols, bx), min(_cdiv(n1, by * ahead), GRID_YZ),
                min(n0, GRID_YZ))

    gx, gy, gz = grid(ROWS_AHEAD)
    ahead = ROWS_AHEAD if gx * gy * gz >= sms else 1
    return CopyPlan("rows4" if aligned else "rows", (bx, by), grid(ahead),
                    ahead)


# the launch's plan, memoised: a call's plan is a pure function of these
_cached_plan = functools.lru_cache(maxsize=PLAN_CACHE)(copy_plan)


def copy_path(x: torch.Tensor) -> str:
    """The path (``PATHS``) ``strided_copy`` takes for the view ``x``."""
    shape, strides = merged(x.shape, x.stride())
    return copy_plan(shape, strides, x.data_ptr() % 16).path


def _check_view(name, v):
    """The view's type and device as ``check_operands`` checks a tensor's,
    with any non-negative strides."""
    if not _build.on_card(v):
        raise ValueError(f"{name}: operand on {v.device}, expected the card")
    if v.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: {v.dtype} is not ported to the card yet (ROADMAP A11); "
            f"this kernel takes torch.float32")
    if min(v.stride()) < 0:
        raise ValueError(f"{name}: negative stride {v.stride()}")


def _launch_transpose(v, out):
    B, R, C = v.shape
    _build.launch("fst_transpose", v.get_device(), _build.ptr(v),
                  _build.ptr(out), B, R, C, *v.stride())


def _launch_copy(x, shape, strides, out, scale):
    """``x``'s elements as the merged ``(shape, strides)`` address them."""
    dev = x.get_device()
    p = _build.ptr(x)
    plan = _cached_plan(shape, strides, p % 16, _build.sm_count(dev))
    _build.launch("fst_strided_copy", dev, p, _build.ptr(out), *shape,
                  *strides, float(scale), PATHS.index(plan.path),
                  *plan.block, *plan.grid, plan.ahead)
