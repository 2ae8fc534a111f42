"""Typed simulation and scene parameters, field for field the JAX package's
``SimParams`` and ``SceneParams``.

The dataclasses, their defaults and their JSON form are the same as
``fluid_simulation_tpu/config.py``, so a parameter file written by one package
is read by the other (``convert.params_from_json``,
``convert.scene_params_from_json``). The reference hardcodes
its grid in ``simulation.cpp:431-435`` and its physics in
``simulation.h:59-64``; both are the defaults here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters.

    Defaults mirror the reference ctor (``simulation.h:59-64``):
    ``speed=30, dt=0.05, diff=2e-5, visc=1.5e-5, acc=15``. ``visc`` is carried
    for parity; like the reference, compat mode diffuses velocity with
    ``diff`` (``simulation.cpp:278-284``).
    """

    width: int = 128   # interior cells along x (simulation.cpp:432)
    height: int = 64   # interior cells along y
    depth: int = 64    # interior cells along z

    dt: float = 0.05
    diff: float = 2.0e-5
    visc: float = 1.5e-5
    acc: int = 15              # linear-solver sweeps per solve
    speed: float = 30.0        # inlet x-velocity (simulation.cpp:105)
    inlet_density: float = 0.001  # added per step on the x=1 plane (simulation.cpp:64-67)

    # 'jacobi' | 'rbgs' (default) | 'gs_wavefront' (numerically identical to
    # the reference's sequential sweep; for parity tests).
    solver: str = "rbgs"

    # 'compat' — the reference's sequential per-component advection chain.
    # 'fast'   — one shared trilinear backtrace through the projected field.
    # 'split'  — operator-split advection, three 1-D lerp passes per field.
    mode: str = "compat"

    use_visc_for_velocity: bool = False

    # Vorticity confinement strength (0 = off).
    vorticity: float = 0.0

    # 'reference' (x- inlet mirror, x+ outflow, mirrored y/z for their own
    # component) or 'noslip' (every velocity component negated at y/z walls).
    wall_mode: str = "reference"

    # 'float32' | 'bfloat16'.
    dtype: str = "float32"

    # Use the hand-written kernels. On a CUDA tensor every kernel of the
    # step launches or raises; False runs the plain torch versions
    # everywhere (the reference path on the card).
    use_pallas: bool = True

    # Compute the max-|divergence| residual in StepStats.
    div_stats: bool = True

    # Collect the per-step density sum in StepStats (NaN when off).
    step_stats: bool = True

    # compat/fast advection: > 0 samples through the trilinear gather kernel
    # (kernels/advect_compat.py) on the card, bit-identical to the plain
    # gather, which the CPU and use_pallas=False run; split ignores it.
    advect_window: int = 0

    # Sharded runs only: each advect reads its z rows from this many
    # neighbour slabs per side, or from the full gather where a backtrace
    # reaches further (parallel/sharded.py::_z_lerp_dispatch); 0 always
    # gathers. The same values either way.
    advect_halo_slabs: int = 1

    # Set by WindTunnel when the obstacle field is empty: obstacle-mask
    # multiplies are exact identities and are skipped.
    empty_scene: bool = False

    # Set by the design sweep's batched route (not ported yet).
    batched: bool = False

    @property
    def interior_shape(self) -> Tuple[int, int, int]:
        """(D, H, W) — z-major so x is the fastest axis."""
        return (self.depth, self.height, self.width)

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        """(D+2, H+2, W+2) incl. the 1-cell ghost shell (simulation.cpp:35)."""
        return (self.depth + 2, self.height + 2, self.width + 2)

    @property
    def n_cells(self) -> int:
        return self.width * self.height * self.depth

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SimParams":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Obstacle placement, mirroring ``loadSTLIntoObstacles``'s signature
    (``simulation.h:94-104``): mesh path + scale + Euler rotation + translate.
    """

    stl_path: Optional[str] = None
    scale: float = 1.0
    rot_x: float = 0.0
    rot_y: float = 0.0
    rot_z: float = 0.0
    translate_x: float = 0.0
    translate_y: float = 0.0
    translate_z: float = 0.0

    # 'bbox_center' rotates about the true bounding-box midpoint;
    # 'origin' replicates the reference behavior where objCenter is always
    # (0,0,0) because the min/max sentinels are never updated
    # (object_loader.cpp:288-296).
    rotation_center: str = "origin"

    # 'rasterize' — deterministic triangle rasterization + parity fill (default)
    # 'ray_parity' — per-point jittered ray casting like the reference
    #                (object_loader.cpp:396-448)
    voxelizer: str = "rasterize"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SceneParams":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
