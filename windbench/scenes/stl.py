"""A solid voxelized from an STL mesh by the program's own loader, as the
reference's ``main()`` loads one (``loadSTLIntoObstacles``,
simulation.h:94-104): ``fluid_simulation_tpu_torch.scene.voxelize.
load_stl_into_obstacles`` with ``SceneParams``' defaults for the engine
(``rasterize``) and the rotation centre. So the cell's ``scene_setup_s``
and ``setup_s`` time the real STL path: the reader and the voxelizer."""

import numpy as np

from fluid_simulation_tpu_torch.config import SceneParams
from fluid_simulation_tpu_torch.scene.primitives import empty_obstacles
from fluid_simulation_tpu_torch.scene.voxelize import load_stl_into_obstacles
from windbench import traffic


def build(width: int, height: int, depth: int, path: str,
          scale: float = 1.0, rot_x: float = 0.0, rot_y: float = 0.0,
          rot_z: float = 0.0, translate_x: float = 0.0,
          translate_y: float = 0.0, translate_z: float = 0.0) -> np.ndarray:
    """Padded (D+2, H+2, W+2) float32 field, 1 in the cells the mesh at
    ``path`` (relative to the checkout's root) fills after the reference's
    scale, Euler rotation (degrees) and translate (cells). Raises where the
    mesh gives no solid cell: the loader then falls back to the empty
    tunnel, which is another scene."""
    mesh = traffic.ROOT.parent / path
    scene = SceneParams(stl_path=str(mesh), scale=scale, rot_x=rot_x,
                        rot_y=rot_y, rot_z=rot_z, translate_x=translate_x,
                        translate_y=translate_y, translate_z=translate_z)
    out = load_stl_into_obstacles(scene, empty_obstacles(width, height,
                                                         depth))
    if not out.any():
        raise ValueError(f"windbench: the STL scene {path!r} gave no solid "
                         "cell (an unreadable mesh, or one outside the grid)")
    return out
