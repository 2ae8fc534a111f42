"""A solid sphere: the cells whose centre lies inside it (the JAX bench's
``obstacle_sphere`` scenes, ``bench.py:221-263``). Built by broadcasting the
three axes, so the host holds one boolean grid and the padded field."""

import numpy as np


def build(width: int, height: int, depth: int, center, radius) -> np.ndarray:
    """Padded (D+2, H+2, W+2) float32 field, 1 inside the sphere of
    ``radius`` about ``center`` = (x, y, z) in 1-based cell coordinates."""
    cx, cy, cz = center
    x = np.arange(1, width + 1, dtype=np.float32).reshape(1, 1, width)
    y = np.arange(1, height + 1, dtype=np.float32).reshape(1, height, 1)
    z = np.arange(1, depth + 1, dtype=np.float32).reshape(depth, 1, 1)
    inside = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= radius ** 2
    out = np.zeros((depth + 2, height + 2, width + 2), np.float32)
    out[1:-1, 1:-1, 1:-1] = inside
    return out
