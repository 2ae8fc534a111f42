"""Carry state and parameters between the JAX package and this one.

Both packages keep the same padded ``(D+2, H+2, W+2)`` fields in the same
order (``vx, vy, vz, dens``) and the same ``SimParams`` and ``SceneParams``
JSON, so NumPy arrays and the JSON text are the whole interface; nothing here
imports JAX. Tensors go to the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def sharded_state_from_numpy(fields: Sequence[np.ndarray],
                             devices) -> List[FluidState]:
    """The per-rank states of a sharded tunnel from four stacked
    ``(n, Dl+2, H+2, W+2)`` arrays in field order (the JAX
    ``ShardedWindTunnel``'s ``state``, through ``np.asarray``): rank r's
    slab goes to ``devices[r]``. Values are copied exactly."""
    if len(fields) != 4:
        raise ValueError(f"expected 4 fields (vx, vy, vz, dens), got "
                         f"{len(fields)}")
    fields = [np.asarray(f) for f in fields]
    shapes = {f.shape for f in fields}
    if len(shapes) != 1 or len(fields[0].shape) != 4:
        raise ValueError("fields must be four stacked (n, Dl+2, H+2, W+2) "
                         "arrays of one shape")
    if len(devices) != fields[0].shape[0]:
        raise ValueError(f"{fields[0].shape[0]} slabs for {len(devices)} "
                         f"devices")
    return [FluidState(*(torch.tensor(f[r], device=d)
                         for f in fields)) for r, d in enumerate(devices)]


def sharded_state_to_numpy(states: Sequence[FluidState]
                           ) -> Tuple[np.ndarray, ...]:
    """The four fields of per-rank states as stacked ``(n, Dl+2, H+2,
    W+2)`` NumPy arrays, the JAX ``ShardedWindTunnel``'s layout."""
    per_rank = [state_to_numpy(st) for st in states]
    return tuple(np.stack([r[k] for r in per_rank]) for k in range(4))


def params_from_json(s: str) -> SimParams:
    """SimParams from the JSON of either package's ``SimParams.to_json()``."""
    return SimParams.from_json(s)


def scene_params_from_json(s: str) -> SceneParams:
    """SceneParams from the JSON of either package's ``SceneParams.to_json()``."""
    return SceneParams.from_json(s)
