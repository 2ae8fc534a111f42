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
  ``store_strided`` (:179, ``a`` times 2).

The probe that times them is ``fluid_simulation_tpu_torch/tools/
exp_transpose.py``; no route of the wind tunnel calls them.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build

MAX_BATCH = 65535   # the transpose's batch is the grid's z dimension


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
    v = x.reshape((1,) * (3 - x.ndim) + tuple(x.shape)) if x.ndim < 3 else x
    _check_view("strided_copy", v)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch_copy(v, out, scale)
    LAUNCHES["strided_copy"] += 1
    return out


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


def _launch_copy(v, out, scale):
    _build.launch("fst_strided_copy", v.get_device(), _build.ptr(v),
                  _build.ptr(out), *v.shape, *v.stride(), float(scale))
