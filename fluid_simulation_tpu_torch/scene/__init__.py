"""Scene construction: STL ingestion, mesh transforms and voxelization (host
NumPy), obstacle primitives, and the solver masks."""

from fluid_simulation_tpu_torch.scene.masks import SceneMasks, build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    add_box, add_sphere, empty_obstacles)
from fluid_simulation_tpu_torch.scene.stl import (
    bounding_sphere_box, read_stl, rotate_triangles, rotation_matrix)
from fluid_simulation_tpu_torch.scene.voxelize import (
    grid_mapping, load_stl_into_obstacles, voxelize_rasterize,
    voxelize_ray_parity)

__all__ = ["SceneMasks", "build_masks", "add_box", "add_sphere",
           "empty_obstacles", "read_stl", "rotation_matrix",
           "rotate_triangles", "bounding_sphere_box", "grid_mapping",
           "voxelize_rasterize", "voxelize_ray_parity",
           "load_stl_into_obstacles"]
