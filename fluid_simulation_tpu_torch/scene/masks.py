"""Precomputed boundary/obstacle masks (``fluid_simulation_tpu/scene/masks.py``).

The reference evaluates per-cell conditionals in every hot loop: setBounds'
solid zeroing and staircase no-slip (``simulation.cpp:218-245``) and
project's obstacle-aware stencils (``simulation.cpp:297-357``). They are
evaluated once per scene here and become multiplies and selects.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SceneMasks(NamedTuple):
    """Masks of one scene, all on one device. Shapes:

    - padded ``(D+2, H+2, W+2)``: ``solid``, ``keep_scalar``, ``keep_vel``
    - interior ``(D, H, W)``: ``fluid_i``, ``red_i`` and the six one-sided
      neighbour-validity masks ``nb_*`` used by the projection.

    ``nb_xp[z,y,x]`` is 1 where the +x neighbour is in the interior and
    fluid (``simulation.cpp:307-312``); the ghost shell never counts.
    """

    solid: torch.Tensor        # padded, 1.0 = solid
    keep_scalar: torch.Tensor  # padded, 0 inside solids, 1 elsewhere
    keep_vel: torch.Tensor     # padded, 0 in solids and fluid cells 6-adjacent to one
    fluid_i: torch.Tensor      # interior, 1.0 = fluid
    red_i: torch.Tensor        # interior, 1.0 where the 1-based x+y+z is even
    nb_xp: torch.Tensor
    nb_xm: torch.Tensor
    nb_yp: torch.Tensor
    nb_ym: torch.Tensor
    nb_zp: torch.Tensor
    nb_zm: torch.Tensor

    @property
    def interior_shape(self):
        return tuple(self.fluid_i.shape)


@torch.inference_mode(False)
def build_masks(obstacles, dtype=torch.float32, device="cuda") -> SceneMasks:
    """Derive every solver mask from the padded obstacle field (1 = solid).

    ``obstacles`` (NumPy array or tensor) has padded shape
    ``(D+2, H+2, W+2)`` with a zero ghost shell. Every mask is 0/1, so it is
    built in float32 and cast to ``dtype`` exactly. The masks go to the card
    unless ``device="cpu"`` asks for the host. They are never inference
    tensors, even under ``torch.inference_mode``: a mask's version counter
    is what lets the streamed keep passes keep its table
    (``kernels/linsolve_stream.march_table``)."""
    obs = torch.as_tensor(np.asarray(obstacles, np.float32)
                          if not isinstance(obstacles, torch.Tensor)
                          else obstacles, dtype=torch.float32, device=device)
    if obs.ndim != 3:
        raise ValueError(f"obstacles must be 3-D padded, got shape {tuple(obs.shape)}")

    solid = (obs >= 0.5).to(torch.float32)
    solid_i = solid[1:-1, 1:-1, 1:-1]
    fluid_i = 1.0 - solid_i

    # fluid cell 6-adjacent to a solid; the zero ghost shell stands in for
    # the reference's i±1 bounds guards
    adj = (solid[1:-1, 1:-1, 2:] + solid[1:-1, 1:-1, :-2]
           + solid[1:-1, 2:, 1:-1] + solid[1:-1, :-2, 1:-1]
           + solid[2:, 1:-1, 1:-1] + solid[:-2, 1:-1, 1:-1])
    adj_fluid_i = ((adj > 0) & (solid_i < 0.5)).to(torch.float32)

    keep_scalar = torch.ones_like(solid)
    keep_scalar[1:-1, 1:-1, 1:-1] = fluid_i
    keep_vel = keep_scalar.clone()
    keep_vel[1:-1, 1:-1, 1:-1] = fluid_i * (1.0 - adj_fluid_i)

    D, H, W = solid_i.shape

    def _inbounds(n, axis, sign):
        coord = torch.arange(1, n + 1, device=device)
        ok = (coord + sign >= 1) & (coord + sign <= n)
        shape = [1, 1, 1]
        shape[axis] = n
        return ok.reshape(shape).to(torch.float32)

    fluid_pad = 1.0 - solid
    nb = dict(
        nb_xp=fluid_pad[1:-1, 1:-1, 2:] * _inbounds(W, 2, +1),
        nb_xm=fluid_pad[1:-1, 1:-1, :-2] * _inbounds(W, 2, -1),
        nb_yp=fluid_pad[1:-1, 2:, 1:-1] * _inbounds(H, 1, +1),
        nb_ym=fluid_pad[1:-1, :-2, 1:-1] * _inbounds(H, 1, -1),
        nb_zp=fluid_pad[2:, 1:-1, 1:-1] * _inbounds(D, 0, +1),
        nb_zm=fluid_pad[:-2, 1:-1, 1:-1] * _inbounds(D, 0, -1),
    )
    red_i = red_parity((D, H, W), device).to(torch.float32)

    def cast(t):
        return t.to(dtype).contiguous()

    return SceneMasks(
        solid=cast(solid), keep_scalar=cast(keep_scalar),
        keep_vel=cast(keep_vel), fluid_i=cast(fluid_i), red_i=cast(red_i),
        **{k: cast(v) for k, v in nb.items()})


def red_parity(interior_shape, device="cpu") -> torch.Tensor:
    """Boolean (D, H, W): the red cells, whose 1-based coordinate sum (equally,
    padded index sum) is even."""
    D, H, W = interior_shape
    zi = torch.arange(1, D + 1, device=device).reshape(D, 1, 1)
    yi = torch.arange(1, H + 1, device=device).reshape(1, H, 1)
    xi = torch.arange(1, W + 1, device=device).reshape(1, 1, W)
    return ((zi + yi + xi) % 2) == 0
