"""Analytic obstacle primitives on the padded grid (NumPy).

Same functions as ``fluid_simulation_tpu/scene/primitives.py``. Coordinates
follow the reference's 1-based interior convention: cell ``(x, y, z)`` with
``1 <= x <= W`` is padded index ``[z, y, x]``.
"""

from __future__ import annotations

import numpy as np


def empty_obstacles(width: int, height: int, depth: int) -> np.ndarray:
    """All-fluid padded obstacle field."""
    return np.zeros((depth + 2, height + 2, width + 2), dtype=np.float32)


def _cell_centers(width: int, height: int, depth: int):
    x = np.arange(1, width + 1, dtype=np.float32)
    y = np.arange(1, height + 1, dtype=np.float32)
    z = np.arange(1, depth + 1, dtype=np.float32)
    return np.meshgrid(z, y, x, indexing="ij")  # (Z, Y, X) grids


def add_box(obs: np.ndarray, x0: int, x1: int, y0: int, y1: int, z0: int,
            z1: int) -> np.ndarray:
    """Mark the inclusive cell range [x0..x1]x[y0..y1]x[z0..z1] solid."""
    D2, H2, W2 = obs.shape
    x0, x1 = max(1, x0), min(W2 - 2, x1)
    y0, y1 = max(1, y0), min(H2 - 2, y1)
    z0, z1 = max(1, z0), min(D2 - 2, z1)
    out = obs.copy()
    out[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1] = 1.0
    return out


def add_sphere(obs: np.ndarray, cx: float, cy: float, cz: float,
               radius: float) -> np.ndarray:
    """Mark cells whose center lies inside the sphere solid."""
    D2, H2, W2 = obs.shape
    Z, Y, X = _cell_centers(W2 - 2, H2 - 2, D2 - 2)
    inside = (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 <= radius ** 2
    out = obs.copy()
    out[1:-1, 1:-1, 1:-1] = np.where(inside, 1.0, out[1:-1, 1:-1, 1:-1])
    return out
