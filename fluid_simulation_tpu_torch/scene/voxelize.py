"""Mesh -> obstacle-mask voxelization: the NumPy engines of
``fluid_simulation_tpu/scene/voxelize.py``, copied because the port may not
import the JAX package. Voxelizing is host preprocessing; the mask it makes
is what ``WindTunnel`` moves to the card.

Two engines, selected by ``SceneParams.voxelizer``:

- ``'rasterize'`` (default): deterministic column-parity voxelization. Each
  (y, z) grid column casts an exact ray along +x; triangle crossings are
  solved analytically and cells whose centers fall between an odd/even
  crossing pair are solid. No RNG, bitwise reproducible, and it fills the
  interior of watertight meshes.

- ``'ray_parity'``: replicates the reference pipeline
  (``object_loader.cpp:270-452``): fine scan grid at resolution
  ``max(objSize/200, 0.02)`` over bounding-sphere bounds (+5% pad), a coarse
  64^3 occupancy grid from triangle AABBs at 5x the fine resolution used as an
  *early-reject* (``:402-414``) — which means only points near triangles are
  ever tested, so solids come out as thick shells, a quirk kept for parity —
  jittered points, one random-direction ray per point (``:417-423``), and
  Moller-Trumbore parity counting. Deterministic here via a seeded RNG.

Both use the reference's world->grid mapping (``:426-438``):
``g = trunc((p - objCenter) * gridScale + gridCenter + translate)`` with
``gridScale = scale * min(W,H,D) / objSize``.

The ray-parity engine also has a C++ OpenMP build (``native/geometry.cpp``,
the port's copy of the JAX package's, same algorithm, same seeding
contract), which ``load_stl_into_obstacles`` runs by default as the JAX
loader does. Its Moller-Trumbore verdicts can differ from NumPy's on rays
that graze a seam, so the two engines may differ by a few cells.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fluid_simulation_tpu_torch.config import SceneParams
from fluid_simulation_tpu_torch.native import geometry as native_geometry
from fluid_simulation_tpu_torch.scene import stl as stl_mod


# --------------------------------------------------------------------------
# world -> simulation-grid mapping (object_loader.cpp:426-438)
# --------------------------------------------------------------------------

def grid_mapping(padded_lo: np.ndarray, padded_hi: np.ndarray,
                 obj_center: np.ndarray, scale: float,
                 W: int, H: int, D: int,
                 translate: Tuple[float, float, float]):
    obj_size = float(np.max(padded_hi - padded_lo))
    grid_scale = np.float32(scale) * np.float32(min(W, H, D)) / np.float32(obj_size)
    grid_center = np.array([W / 2, H / 2, D / 2], dtype=np.float32)
    t = np.asarray(translate, dtype=np.float32)

    def to_grid(points: np.ndarray) -> np.ndarray:
        return (points - obj_center) * grid_scale + grid_center + t

    return to_grid, float(grid_scale)


# --------------------------------------------------------------------------
# deterministic column-parity engine
# --------------------------------------------------------------------------

def voxelize_rasterize(tris_grid: np.ndarray, W: int, H: int, D: int
                       ) -> np.ndarray:
    """Voxelize triangles already in grid space into a padded (D+2,H+2,W+2)
    mask. Cell (x,y,z), 1-based, covers [x, x+1) etc. in grid coordinates;
    a cell is solid when its center (x+.5, y+.5, z+.5) is inside the mesh."""
    obs = np.zeros((D + 2, H + 2, W + 2), dtype=np.float32)
    if len(tris_grid) == 0:
        return obs

    v1, v2, v3 = tris_grid[:, 0], tris_grid[:, 1], tris_grid[:, 2]
    # columns are indexed by solid-cell coordinates: the column (y, z) has
    # its ray at (y + .5 + ey, z + .5 + ez); the tiny deterministic offsets
    # keep rays off shared triangle edges/diagonals, where both triangles
    # would report the same crossing and the parity would cancel.
    EY, EZ = 1.04723e-5, 2.71828e-5
    crossings_col = []
    crossings_x = []
    for a, b, c in zip(v1, v2, v3):
        ymin = max(1, int(np.ceil(min(a[1], b[1], c[1]) - 0.5)))
        ymax = min(H, int(np.floor(max(a[1], b[1], c[1]) - 0.5)))
        zmin = max(1, int(np.ceil(min(a[2], b[2], c[2]) - 0.5)))
        zmax = min(D, int(np.floor(max(a[2], b[2], c[2]) - 0.5)))
        if ymin > ymax or zmin > zmax:
            continue
        ys = np.arange(ymin, ymax + 1, dtype=np.float64) + 0.5 + EY
        zs = np.arange(zmin, zmax + 1, dtype=np.float64) + 0.5 + EZ
        Y, Z = np.meshgrid(ys, zs, indexing="ij")
        # barycentric in the (y, z) projection
        d = ((b[1] - a[1]) * (c[2] - a[2]) - (c[1] - a[1]) * (b[2] - a[2]))
        if abs(d) < 1e-12:
            continue  # degenerate projection; neighbors cover the crossing
        w1 = ((Y - a[1]) * (c[2] - a[2]) - (c[1] - a[1]) * (Z - a[2])) / d
        w2 = ((b[1] - a[1]) * (Z - a[2]) - (Y - a[1]) * (b[2] - a[2])) / d
        inside = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
        if not inside.any():
            continue
        xs = a[0] + w1 * (b[0] - a[0]) + w2 * (c[0] - a[0])
        yy = (Y[inside] - 0.5).astype(np.int64)
        zz = (Z[inside] - 0.5).astype(np.int64)
        crossings_col.append(zz * (H + 2) + yy)
        crossings_x.append(xs[inside])

    if not crossings_col:
        return obs
    col = np.concatenate(crossings_col)
    xs = np.concatenate(crossings_x)
    order = np.lexsort((xs, col))
    col, xs = col[order], xs[order]

    # per-column parity fill between successive crossing pairs
    starts = np.flatnonzero(np.r_[True, col[1:] != col[:-1]])
    ends = np.r_[starts[1:], len(col)]
    for s, e in zip(starts, ends):
        cxs = xs[s:e]
        if len(cxs) < 2:
            continue
        z = int(col[s]) // (H + 2)
        y = int(col[s]) % (H + 2)
        for i in range(0, len(cxs) - 1, 2):
            x0 = int(np.ceil(cxs[i] - 0.5))
            x1 = int(np.floor(cxs[i + 1] - 0.5 - 1e-9))
            if x1 >= x0:
                obs[z, y, max(1, x0):min(W, x1) + 1] = 1.0
    return obs


# --------------------------------------------------------------------------
# compat ray-parity engine (reference algorithm, vectorized)
# --------------------------------------------------------------------------

# Counter-based RNG shared with the C++ engine (native/geometry.cpp): the
# reference seeds a minstd generator per OpenMP thread from the thread-id
# hash (object_loader.cpp:399), making results run-dependent; here every
# sample is a pure function of (seed, fine-point linear index, channel), so
# NumPy, C++, and any thread count produce identical masks.
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    z = x.astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _u01(seed: int, lin_idx: np.ndarray, channel: int) -> np.ndarray:
    """Uniform [0,1) double per (point, channel)."""
    ctr = (lin_idx.astype(np.uint64) * np.uint64(6)
           + np.uint64(channel + 1)) * _GOLDEN + np.uint64(seed)
    h = _splitmix64(ctr)
    return (h >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def _ray_parity_inside(points: np.ndarray, dirs: np.ndarray,
                       tris: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """Moller-Trumbore parity test (object_loader.cpp:205-244), vectorized
    over points x triangles in chunks."""
    v1 = tris[:, 0]
    e1 = tris[:, 1] - v1     # (T, 3)
    e2 = tris[:, 2] - v1
    inside = np.zeros(len(points), dtype=bool)
    for s in range(0, len(points), chunk):
        p = points[s:s + chunk][:, None, :]       # (N, 1, 3)
        dn = dirs[s:s + chunk]                    # (N, 3)
        h = np.cross(dn[:, None, :], e2[None, :, :])   # (N, T, 3)
        aa = np.einsum("tk,ntk->nt", e1, h)
        with np.errstate(divide="ignore", invalid="ignore"):
            f = 1.0 / aa
            sv = p - v1[None, :, :]
            u = f * np.einsum("ntk,ntk->nt", sv, h)
            q = np.cross(sv, e1[None, :, :])
            v = f * np.einsum("nk,ntk->nt", dn, q)
            t = f * np.einsum("tk,ntk->nt", e2, q)
        hit = ((np.abs(aa) >= 1e-6) & (u >= 0) & (u <= 1)
               & (v >= 0) & (u + v <= 1) & (t > 1e-3))
        inside[s:s + chunk] = (hit.sum(axis=1) % 2) == 1
    return inside


def voxelize_ray_parity(tris: np.ndarray, obj_center: np.ndarray,
                        padded_lo: np.ndarray, padded_hi: np.ndarray,
                        scale: float, W: int, H: int, D: int,
                        translate: Tuple[float, float, float],
                        seed: int = 0,
                        fine_divisor: float = 200.0) -> np.ndarray:
    """The reference pipeline on the rotated triangles (see module docstring).
    Returns the padded obstacle mask. ``fine_divisor=200`` is the reference
    fine-grid rule (object_loader.cpp:368); tests shrink it to bound cost."""
    obj_size = float(np.max(padded_hi - padded_lo))
    resolution = max(obj_size / fine_divisor, 0.02)  # object_loader.cpp:368
    n = ((padded_hi - padded_lo) / resolution).astype(int)  # :370-372

    # coarse occupancy grid: 64^3, cell = 5x fine resolution (:380-389)
    coarse_res = resolution * 5.0
    gsz = 64
    occ = np.zeros((gsz, gsz, gsz), dtype=bool)
    tmin = tris.min(axis=1)
    tmax = tris.max(axis=1)
    lo_idx = np.clip(((tmin - padded_lo) / coarse_res).astype(int), 0, gsz - 1)
    hi_idx = np.clip(((tmax - padded_lo) / coarse_res).astype(int), 0, gsz - 1)
    for (x0, y0, z0), (x1, y1, z1) in zip(lo_idx, hi_idx):
        occ[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = True

    # fine scan points (:403-409), early-rejected through the coarse grid
    ix = np.arange(n[0]); iy = np.arange(n[1]); iz = np.arange(n[2])
    P = np.stack(np.meshgrid(ix, iy, iz, indexing="ij"), axis=-1
                 ).reshape(-1, 3).astype(np.float64)
    pts = padded_lo + P * resolution
    ci = ((pts - padded_lo) / coarse_res).astype(int)
    # out-of-grid points are rejected, not clipped (object_loader.cpp:84-85)
    inb = np.all((ci >= 0) & (ci < gsz), axis=1)
    keep = np.zeros(len(pts), dtype=bool)
    keep[inb] = occ[ci[inb, 0], ci[inb, 1], ci[inb, 2]]
    pts = pts[keep]
    if len(pts) == 0:
        return np.zeros((D + 2, H + 2, W + 2), dtype=np.float32)
    lin = np.flatnonzero(keep)

    # jitter in [-5e-4, 5e-4) and ray dirs in [0.1, 1.0) like the reference
    # (object_loader.cpp:417-422), but counter-based (see _u01)
    jit = np.stack([_u01(seed, lin, c) for c in range(3)], axis=1)
    pts = pts + (jit * 1e-3 - 5e-4)
    dirs = np.stack([0.1 + 0.9 * _u01(seed, lin, 3 + c) for c in range(3)],
                    axis=1)

    inside = _ray_parity_inside(pts, dirs, tris.astype(np.float64))
    pin = pts[inside]

    to_grid, _ = grid_mapping(padded_lo, padded_hi, obj_center, scale,
                              W, H, D, translate)
    g = np.trunc(to_grid(pin)).astype(int)                           # :432-434
    ok = ((g[:, 0] >= 1) & (g[:, 0] <= W) & (g[:, 1] >= 1) & (g[:, 1] <= H)
          & (g[:, 2] >= 1) & (g[:, 2] <= D))
    g = g[ok]
    obs = np.zeros((D + 2, H + 2, W + 2), dtype=np.float32)
    obs[g[:, 2], g[:, 1], g[:, 0]] = 1.0
    return obs


# --------------------------------------------------------------------------
# top-level: the loadSTLIntoObstacles equivalent (simulation.h:94-104)
# --------------------------------------------------------------------------

def load_stl_into_obstacles(scene: SceneParams, obs: np.ndarray,
                            seed: int = 0,
                            use_native: bool = True) -> np.ndarray:
    """Voxelize ``scene.stl_path`` into the padded obstacle mask ``obs``
    (OR-combined with existing obstacles). On any failure to read the mesh
    this returns ``obs`` unchanged, like the reference's graceful
    degradation (object_loader.cpp:282-285).

    With ``voxelizer='ray_parity'``, ``use_native`` runs the C++ engine
    (``native/geometry.py``) and ``use_native=False`` the NumPy one. Unlike
    the JAX loader, which falls back to NumPy when its library is missing,
    a native build or load failure raises ``RuntimeError``: the two engines
    may differ by a few cells, so a silent switch would change the scene."""
    D2, H2, W2 = obs.shape
    W, H, D = W2 - 2, H2 - 2, D2 - 2
    try:
        tris = stl_mod.read_stl(scene.stl_path)
    except (OSError, ValueError) as e:
        print(f"Failed to load STL: {scene.stl_path} ({e})")
        return obs
    if len(tris) == 0:
        print(f"Failed to load STL: {scene.stl_path} (no triangles)")
        return obs

    rotated, center = stl_mod.rotate_triangles(
        tris, scene.rot_x, scene.rot_y, scene.rot_z,
        center=scene.rotation_center)
    # bounding sphere measured on unrotated tris like the reference
    # (object_loader.cpp:328-334); rotation about the center preserves it
    lo, hi, _ = stl_mod.bounding_sphere_box(tris, center)
    translate = (scene.translate_x, scene.translate_y, scene.translate_z)

    if scene.voxelizer == "ray_parity":
        engine = (native_geometry.voxelize_ray_parity if use_native
                  else voxelize_ray_parity)
        mask = engine(rotated, center, lo, hi, scene.scale, W, H, D,
                      translate, seed=seed)
    elif scene.voxelizer == "rasterize":
        to_grid, _ = grid_mapping(lo, hi, center, scene.scale, W, H, D,
                                  translate)
        tris_grid = to_grid(rotated.reshape(-1, 3)).reshape(-1, 3, 3)
        mask = voxelize_rasterize(tris_grid.astype(np.float64), W, H, D)
    else:
        raise ValueError(f"unknown voxelizer {scene.voxelizer!r}")
    return np.maximum(obs, mask)
