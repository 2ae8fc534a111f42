"""ROADMAP B23: the launch-overhead probe's tiny kernel (``csrc/probe.cu``)
and its plain torch version.

Port of the tiny kernel of ``tools/exp_overhead.py`` (``tiny_kernel``,
:49-58), ``o = x + 1`` on an (8, 128) f32 tile in one call: its own work is
nothing, so back-to-back calls time the cost of a launch. The probe that
times it is ``fluid_simulation_tpu_torch/tools/exp_overhead.py``.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` in plain torch."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` as a new tensor. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one launch) or raises."""
    if not _build.on_card(x):
        return add_one_plain(x)
    _build.check_operands("probe_add1", (x,))
    if not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"probe_add1: {x.numel()} elements; the kernel "
                         f"takes 1 to 2^31 - 1")
    out = torch.empty_like(x)
    _launch(x, out)
    LAUNCHES["probe_add1"] += 1
    return out


def _launch(x, out):
    _build.launch("fst_probe_add1", x.get_device(), x.data_ptr(),
                  out.data_ptr(), x.numel())
