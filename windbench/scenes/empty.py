"""The empty tunnel: no solid cell."""

import numpy as np


def build(width: int, height: int, depth: int) -> np.ndarray:
    """Padded (D+2, H+2, W+2) float32 field of zeros."""
    return np.zeros((depth + 2, height + 2, width + 2), np.float32)
