"""The step's statistics in one pass over the fields (``csrc/stats.cu``)
and their plain torch version.

No TPU kernel stands behind it: in the JAX package the density sum and
the largest |divergence| (``fluid_simulation_tpu/models/windtunnel.py``)
are glue that XLA fused. ``step_stats`` returns ``(density_sum,
max_divergence)``, two 0-d float32 tensors: the float32 sum of the whole
padded ``dens``, ghosts included, and max |``ops/project.divergence``|
over the interior, each NaN where its flag is off. The step makes no
host-to-device copy for a NaN: it comes from a device fill.

On the card both are views of one (2,) buffer that the kernel writes. The
divergence is bitwise the plain one's; the sum runs in a fixed order (each
thread's cells in turn, then a warp and block tree, then the blocks'
partials in block order), so it is the same bits on every run and differs
from ``torch.sum`` by rounding only.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.kernels.project import _coefficients
from fluid_simulation_tpu_torch.ops.project import divergence, grid_h
from fluid_simulation_tpu_torch.scene.masks import SceneMasks

# blocks of the first launch an SM streams with (csrc/stats.cu kBlocksPerSm)
BLOCKS_PER_SM = 3


def _nan(device, n=()):
    return torch.full(n, float("nan"), dtype=torch.float32, device=device)


def step_stats_plain(vx, vy, vz, dens, masks: SceneMasks,
                     divergence_on: bool = True, density_on: bool = True):
    """The statistics in plain torch: the obstacle-aware divergence as a
    padded field, its |max|, and ``torch.sum`` of ``dens``."""
    nan = None if divergence_on and density_on else _nan(vx.device)
    if divergence_on:
        D2, H2, W2 = vx.shape
        h = grid_h(W2 - 2, H2 - 2, D2 - 2)
        max_div = divergence(vx, vy, vz, masks, h).abs().max().to(
            torch.float32)
    else:
        max_div = nan
    density_sum = (torch.sum(dens, dtype=torch.float32) if density_on
                   else nan)
    return density_sum, max_div


def step_stats(vx, vy, vz, dens, masks: SceneMasks,
               empty_scene: bool = False, divergence_on: bool = True,
               density_on: bool = True):
    """``(density_sum, max_divergence)`` of the padded fields. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (one pass
    and one launch that adds the blocks' partials) or raises, and with
    both statistics off only fills NaN. ``empty_scene`` takes the
    divergence's in-bounds form, which reads no ``fluid_i``: it gives the
    masked form's |div| on finite fields of a scene without solids."""
    if not _build.on_card(vx):
        return step_stats_plain(vx, vy, vz, dens, masks, divergence_on,
                                density_on)
    if not (divergence_on or density_on):
        out = _nan(vx.device, (2,))
        return out[0], out[1]
    _build.check_operands("step_stats", (vx, vy, vz, dens),
                          (None, vx.shape, vx.shape, vx.shape))
    fluid_i = None if empty_scene else masks.fluid_i
    out = vx.new_empty((2,))
    _launch(vx, vy, vz, dens, fluid_i, out, divergence_on, density_on)
    LAUNCHES["step_stats"] += 1
    return out[0], out[1]


def _launch(vx, vy, vz, dens, fluid_i, out, divergence_on, density_on):
    D, H, W = (n - 2 for n in vx.shape)
    ptr, dev = _build.ptr, vx.get_device()
    fl = ((None, 0, 0) if fluid_i is None
          else _build.mask_view("step_stats", fluid_i, (D, H, W), dev))
    blocks = _build.sm_count(dev) * BLOCKS_PER_SM
    part = vx.new_empty((2 * blocks,))
    nhh = float(_coefficients(vx.shape)[0])
    _build.launch("fst_step_stats", dev, ptr(vx), ptr(vy), ptr(vz),
                  ptr(dens), *fl, ptr(part), ptr(out), blocks, D, H, W, nhh,
                  int(divergence_on), int(density_on))
