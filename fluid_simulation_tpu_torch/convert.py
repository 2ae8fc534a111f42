"""Carry state and parameters between the JAX package and this one.

Both packages keep the same padded ``(D+2, H+2, W+2)`` fields in the same
order (``vx, vy, vz, dens``) and the same ``SimParams`` and ``SceneParams``
JSON, so NumPy arrays and the JSON text are the whole interface; nothing here
imports JAX. Tensors go to the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fluid_simulation_tpu_torch.config import SceneParams, SimParams
from fluid_simulation_tpu_torch.models.windtunnel import FluidState


def state_from_numpy(fields: Sequence[np.ndarray], device="cuda",
                     dtype=None) -> FluidState:
    """A FluidState from four padded arrays in field order — for example
    ``tuple(np.asarray(f) for f in jax_state)``. Values are copied exactly;
    ``dtype`` defaults to the arrays' own. ``device="cpu"`` keeps them on
    the host; the default, the card, raises where there is none."""
    if len(fields) != 4:
        raise ValueError(f"expected 4 fields (vx, vy, vz, dens), got "
                         f"{len(fields)}")
    shapes = {np.shape(f) for f in fields}
    if len(shapes) != 1 or len(shapes.pop()) != 3:
        raise ValueError("fields must be four padded 3-D arrays of one shape")
    return FluidState(*(torch.tensor(np.asarray(f), dtype=dtype, device=device)
                        for f in fields))


def state_to_numpy(state: FluidState) -> Tuple[np.ndarray, ...]:
    """The four fields as NumPy arrays in field order, for the JAX package's
    ``FluidState(*arrays)``. bfloat16 fields come back as float32 (exact)."""
    return tuple((f.float() if f.dtype == torch.bfloat16 else f)
                 .detach().cpu().numpy() for f in state)


def params_from_json(s: str) -> SimParams:
    """SimParams from the JSON of either package's ``SimParams.to_json()``."""
    return SimParams.from_json(s)


def scene_params_from_json(s: str) -> SceneParams:
    """SceneParams from the JSON of either package's ``SceneParams.to_json()``."""
    return SceneParams.from_json(s)
