"""ROADMAP B24: the degrade variants of K3's stacked x pass
(``csrc/lerpcost.cu``) and their plain torch version.

Port of the kernel of ``tools/exp_lerpcost.py`` (``main.make_kernel``
:29-53), which the tool patches over
``advect_pallas._make_lerp_kernel_stack`` so that it runs inside K3's
``lane_lerp_stack``: a (Bn, R, C) f32 stack lerped at one (R, Co) index
plane ``xb`` that all Bn fields share, into (Bn, R, Co). Output columns
fall in chunks of 128 lanes, and ``l = c mod 128`` is column c's lane in
its chunk. For every variant ``i0 = clip(floor(xb), 0, C-2)``,
``s = xb - i0`` and ``out = a*(1-s) + b*s``; ``VARIANTS`` in order:

- ``full``: ``a, b = arr[r, i0], arr[r, i0+1]``, the production stacked
  pass (its 128-lane windows are value-identical to this direct gather);
- ``gather1``: ``li = min(i0, 126)``; ``a, b = arr[r, li], arr[r, li+1]``,
  the first window only (``s`` keeps the unclipped ``i0``);
- ``nogather``: ``a = b = ((0 + arr[r, off0+l]) + arr[r, off1+l]) + ...``
  over the window offsets (``window_offsets``): no gather;
- ``copy``: ``a = b = arr[r, l]``, the DMA alone.

Only ``full`` computes the pass. The probe that times them is
``fluid_simulation_tpu_torch/tools/exp_lerpcost.py``; no route of the wind
tunnel calls them.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build

VARIANTS = ("full", "gather1", "nogather", "copy")
# lane_lerp_stack's widest gather axis (advect_pallas.LANE_LERP_MAX_C)
MAX_C = 1664
LANES = 128


def window_offsets(C: int):
    """Offsets of the overlapping 128-lane windows that cover ``i0`` in
    ``[0, C-2]``: stride 127, the last clamped to end at lane C-1
    (``advect_pallas._window_offsets``)."""
    offs, off = [], 0
    while True:
        off = min(off, C - LANES)
        offs.append(off)
        if off + LANES - 2 >= C - 2:
            return offs
        off += LANES - 1


def _check(arr, xb, variant):
    """Refuse what ``lane_lerp_stack`` and the tool's bodies refuse, on
    every device."""
    if variant not in VARIANTS:
        raise ValueError(f"lerpcost_pass: unknown variant {variant!r}; one "
                         f"of {VARIANTS}")
    for t in (arr, xb):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"lerpcost_pass: {t.dtype} is not ported to the card yet "
                f"(ROADMAP A11); this kernel takes torch.float32")
    if arr.ndim != 3 or xb.ndim != 2 or arr.shape[1] != xb.shape[0]:
        raise ValueError(f"lerpcost_pass: row mismatch {tuple(arr.shape)} vs "
                         f"{tuple(xb.shape)}")
    C, Co = arr.shape[2], xb.shape[1]
    if C > MAX_C:
        raise ValueError(f"lerpcost_pass: gather axis too wide for the lane "
                         f"kernel: {C}")
    if C <= LANES and Co != C:
        raise ValueError("lerpcost_pass: single-window path needs idx width "
                         "== C")
    if C < 2 or Co < 1:
        raise ValueError(f"lerpcost_pass: {C} source and {Co} output lanes")
    # the degrade bodies slice 128-lane windows and lerp 128-lane blocks
    if variant != "full" and min(C, Co) < LANES:
        raise ValueError(f"lerpcost_pass: {variant} takes C and Co of at "
                         f"least {LANES}, got {C} and {Co}")


def lerpcost_pass_plain(arr: torch.Tensor, xb: torch.Tensor,
                        variant: str = "full") -> torch.Tensor:
    """The variant in plain torch, in the kernel's operation order."""
    _check(arr, xb, variant)
    Bn, R, C = arr.shape
    Co = xb.shape[1]
    i0 = torch.floor(xb).to(torch.int64).clamp(0, C - 2)
    s = xb - i0.to(torch.float32)
    if variant in ("full", "gather1"):
        lo = i0 if variant == "full" else i0.clamp(max=LANES - 2)
        lo = lo.unsqueeze(0).expand(Bn, R, Co)
        a = torch.gather(arr, 2, lo)
        b = torch.gather(arr, 2, lo + 1)
    else:
        lane = torch.arange(Co, device=arr.device) % LANES
        if variant == "copy":
            a = arr[:, :, lane]
        else:
            a = torch.zeros((Bn, R, Co), dtype=torch.float32,
                            device=arr.device)
            for off in window_offsets(C):
                a = a + arr[:, :, lane + off]
        b = a
    return a * (1.0 - s) + b * s


def lerpcost_pass(arr: torch.Tensor, xb: torch.Tensor,
                  variant: str = "full") -> torch.Tensor:
    """The variant as a new (Bn, R, Co) tensor. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one launch) or raises."""
    _check(arr, xb, variant)
    if not _build.on_card(arr):
        return lerpcost_pass_plain(arr, xb, variant)
    name = "lerpcost_pass"
    _build.check_operands(name, (arr, xb))
    out = arr.new_empty((arr.shape[0], arr.shape[1], xb.shape[1]))
    _launch(arr, xb, out, variant)
    LAUNCHES[name] += 1
    return out


def _launch(arr, xb, out, variant):
    Bn, R, C = arr.shape
    ptr = _build.ptr
    _build.launch("fst_lerpcost_pass", arr.get_device(), ptr(arr), ptr(xb),
                  ptr(out), Bn, R, C, xb.shape[1], VARIANTS.index(variant))
