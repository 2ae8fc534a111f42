"""STL mesh ingestion (NumPy, vectorized): a copy of
``fluid_simulation_tpu/scene/stl.py``, which the port may not import.

Covers the reference's reader (``object_loader.cpp:98-174``): binary and ASCII
autodetected the same way — if the first line doesn't start with ``solid`` the
file is binary (``:107``). Binary layout: 80-byte header, uint32 triangle
count, then 50-byte records (normal 3f, three vertices 3f each, uint16
attribute) (``:112-142``). The parse is a single ``np.frombuffer`` with a
structured dtype instead of per-triangle reads.

Also the mesh transform (``object_loader.cpp:177-202``): Euler rotation with
combined matrix R = Rx·Ry·Rz applied about a center. The reference's center is
always (0,0,0) because its bbox sentinels are never updated before the
midpoint is taken (``:288-296``) — ``rotation_center='origin'`` replicates
that; ``'bbox_center'`` does what the code visibly intended.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_BIN_TRI_DTYPE = np.dtype([
    ("normal", "<f4", (3,)),
    ("verts", "<f4", (3, 3)),
    ("attr", "<u2"),
])


def read_stl(path: str) -> np.ndarray:
    """Return triangles as an (N, 3, 3) float32 array of vertices."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot open STL file: {path}")
    with open(path, "rb") as f:
        head = f.read(1024)
    first_line = head.split(b"\n", 1)[0].strip()
    if first_line.startswith(b"solid"):
        # Caution: binary STLs sometimes start with "solid" too — the
        # reference would misparse those (object_loader.cpp:107); we fall back
        # to binary when ASCII parsing yields nothing.
        tris = _read_ascii(path)
        if len(tris):
            return tris
    return _read_binary(path)


def _read_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 84:
        raise ValueError(f"binary STL too short: {path}")
    n = int(np.frombuffer(raw[80:84], dtype="<u4")[0])
    need = 84 + n * _BIN_TRI_DTYPE.itemsize
    if len(raw) < need:
        raise ValueError(
            f"binary STL truncated: {path} has {len(raw)} bytes, needs {need}")
    recs = np.frombuffer(raw[84:need], dtype=_BIN_TRI_DTYPE)
    return np.ascontiguousarray(recs["verts"], dtype=np.float32)


def _read_ascii(path: str) -> np.ndarray:
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if s.startswith("vertex"):
                parts = s.split()
                if len(parts) >= 4:
                    verts.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
    arr = np.asarray(verts, dtype=np.float32)
    n = (len(arr) // 3) * 3
    return arr[:n].reshape(-1, 3, 3)


def rotation_matrix(rot_x_deg: float, rot_y_deg: float, rot_z_deg: float
                    ) -> np.ndarray:
    """Combined R = Rx·Ry·Rz (object_loader.cpp:182-199), float32."""
    rx, ry, rz = (np.deg2rad(v).astype(np.float32)
                  for v in np.float32([rot_x_deg, rot_y_deg, rot_z_deg]))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    return (Rx @ Ry @ Rz).astype(np.float32)


def rotate_triangles(tris: np.ndarray, rot_x: float, rot_y: float,
                     rot_z: float, center: str = "origin"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate all triangles about a center; returns (rotated, center_point).

    ``center='origin'`` replicates the reference's objCenter == (0,0,0)
    behavior (object_loader.cpp:288-296); ``'bbox_center'`` uses the real
    bounding-box midpoint.
    """
    if center == "origin":
        c = np.zeros(3, dtype=np.float32)
    elif center == "bbox_center":
        c = ((tris.reshape(-1, 3).min(0) + tris.reshape(-1, 3).max(0)) / 2
             ).astype(np.float32)
    else:
        raise ValueError(f"unknown rotation center {center!r}")
    R = rotation_matrix(rot_x, rot_y, rot_z)
    flat = tris.reshape(-1, 3) - c
    rotated = flat @ R.T + c
    return rotated.reshape(-1, 3, 3).astype(np.float32), c


def bounding_sphere_box(tris: np.ndarray, center: np.ndarray,
                        pad_frac: float = 0.05
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Cubic bounds from the bounding-sphere radius about ``center`` plus a
    5% pad — the reference's scan volume (object_loader.cpp:318-359). The
    radius is measured on the *unrotated* triangles there (:328-334); rotation
    about the center preserves it, so we take whichever set is passed in."""
    d2 = ((tris.reshape(-1, 3) - center) ** 2).sum(axis=1)
    r = float(np.sqrt(d2.max()))
    pad = r * pad_frac
    lo = center - (r + pad)
    hi = center + (r + pad)
    return lo.astype(np.float32), hi.astype(np.float32), r
