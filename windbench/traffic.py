"""The benchmark's one generator: a cell's data file and a seed in, the
inputs of a run out.

A cell (``workloads/<cell>.json``) names its configuration, its scene (a
module of ``scenes/`` and that module's arguments), the frame cadence
(``frame_steps`` steps, then the frame's stats read back to the host) and
the ranges of the seeded initial state. From ``--seed`` the generator makes
the state the run restarts from, on the device, in one call of a
``torch.Generator``: every field uniform in its range, zero in the solids,
the ghost faces the mirror of the interior edge as a step leaves them
(negated for a field's own velocity component, the x+ face a copy), ghost
edges and corners zero. It also draws where in the window the run captures
steps for the check (``capture_points``).
"""

from __future__ import annotations

import importlib
import json
import random
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIELDS = ("vx", "vy", "vz", "dens")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(ROOT / kind / f"{name}.json") as fh:
        return json.load(fh)


def scene(spec: dict, config: dict) -> np.ndarray:
    """The padded obstacle field (1 = solid) that ``scenes/<kind>.py``
    builds for the configuration's grid."""
    mod = importlib.import_module(f"windbench.scenes.{spec['kind']}")
    args = {k: v for k, v in spec.items() if k != "kind"}
    return mod.build(config["width"], config["height"], config["depth"],
                     **args)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def initial_state(obstacles: np.ndarray, init: dict, seed: int,
                  device) -> tuple:
    """(vx, vy, vz, dens) padded float32 fields on ``device`` from ``seed``:
    uniform in ``init[name] = [lo, hi]``, zero in solids, mirrored faces."""
    D2, H2, W2 = obstacles.shape
    u = torch.rand((4, D2 - 2, H2 - 2, W2 - 2), generator=_generator(
        seed, device), device=device, dtype=torch.float32)
    lo = torch.tensor([init[k][0] for k in FIELDS], device=device)
    hi = torch.tensor([init[k][1] for k in FIELDS], device=device)
    fluid = torch.as_tensor(obstacles[1:-1, 1:-1, 1:-1] < 0.5, device=device)
    u = (lo.reshape(4, 1, 1, 1) + (hi - lo).reshape(4, 1, 1, 1) * u) * fluid
    out = u.new_zeros((4, D2, H2, W2))
    out[:, 1:-1, 1:-1, 1:-1] = u
    for i, own in enumerate((1, 2, 3, 0)):   # the negated face of each field
        f, s = out[i], [-1.0 if own == k else 1.0 for k in (1, 2, 3)]
        f[1:-1, 1:-1, 0] = s[0] * f[1:-1, 1:-1, 1]
        f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
        f[1:-1, 0, 1:-1] = s[1] * f[1:-1, 1, 1:-1]
        f[1:-1, -1, 1:-1] = s[1] * f[1:-1, -2, 1:-1]
        f[0, 1:-1, 1:-1] = s[2] * f[1, 1:-1, 1:-1]
        f[-1, 1:-1, 1:-1] = s[2] * f[-2, 1:-1, 1:-1]
    return tuple(out.unbind(0))


def capture_points(seed: int, n: int) -> list:
    """``n`` sorted points of the window, as shares of its length in
    [0.05, 0.9], drawn from ``seed``: each run checks the first step of the
    first frame that starts after each point."""
    rng = random.Random(seed)
    return sorted(rng.uniform(0.05, 0.9) for _ in range(n))
