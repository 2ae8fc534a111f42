"""Build, load and call the native ray-parity voxelizer (``geometry.cpp``).

The source compiles with ``g++`` at first use into
``<checkout>/build/fst_native/<hash>/``, keyed on a hash of the source and
flags, so a fresh checkout builds itself and an edited source rebuilds. The
flags are the JAX package's (``fluid_simulation_tpu/native/Makefile``):
``-ffp-contract=off`` keeps the double-precision ray math free of fused
multiply-adds, so this build and the JAX package's give the same mask.

Unlike the JAX package's loader, nothing here falls back to NumPy: a
compiler error, a missing compiler or a library that does not load raises
``RuntimeError`` with the compiler's message. Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("geometry.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fst_native"
LIB_NAME = "libfst_geometry.so"
CXX = "g++"
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-fopenmp", "-ffp-contract=off")
ABI_VERSION = 3      # fstpu_abi_version() in geometry.cpp


def build() -> Path:
    """Compile the library unless one for this source exists; returns its
    path. Raises ``RuntimeError`` naming the compiler's error."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        try:
            res = subprocess.run([CXX, *CXX_FLAGS, "-shared", "-o", tmp,
                                  str(SOURCE)], capture_output=True,
                                 text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"native voxelizer: cannot run the compiler "
                               f"{CXX!r}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"native voxelizer: {CXX} failed on "
                               f"{SOURCE.name} (rc {res.returncode}):\n"
                               f"{(res.stdout + res.stderr)[-4000:]}")
        os.replace(tmp, lib)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library (built on first call, then cached)."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native voxelizer: cannot load {path}: {e}") \
            from e
    lib.fstpu_abi_version.restype = ctypes.c_long
    lib.fstpu_abi_version.argtypes = []
    got = lib.fstpu_abi_version()
    if got != ABI_VERSION:
        raise RuntimeError(f"native voxelizer: {path} has ABI version {got}, "
                           f"expected {ABI_VERSION}")
    fn = lib.fstpu_voxelize_ray_parity
    fn.restype = ctypes.c_long
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_uint64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def voxelize_ray_parity(tris: np.ndarray, obj_center: np.ndarray,
                        padded_lo: np.ndarray, padded_hi: np.ndarray,
                        scale: float, W: int, H: int, D: int,
                        translate: Tuple[float, float, float],
                        seed: int = 0,
                        fine_divisor: float = 200.0) -> np.ndarray:
    """``scene.voxelize.voxelize_ray_parity`` computed by the OpenMP engine,
    with the same arguments. Returns the padded (D+2, H+2, W+2) mask."""
    tris_f = np.ascontiguousarray(tris, dtype=np.float32)
    if tris_f.ndim != 3 or tris_f.shape[1:] != (3, 3):
        raise ValueError(f"triangles of shape {tris_f.shape}, expected "
                         f"(n, 3, 3)")
    lo, hi, ctr, tr = (np.ascontiguousarray(v, dtype=np.float64).reshape(3)
                       for v in (padded_lo, padded_hi, obj_center, translate))
    out = np.zeros((D + 2, H + 2, W + 2), dtype=np.float32)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    library().fstpu_voxelize_ray_parity(
        p(tris_f, ctypes.c_float), len(tris_f), p(lo, ctypes.c_double),
        p(hi, ctypes.c_double), p(ctr, ctypes.c_double), float(scale), W, H,
        D, p(tr, ctypes.c_double), int(seed) & (2 ** 64 - 1),
        float(fine_divisor), p(out, ctypes.c_float))
    return out
