"""Scene construction: obstacle primitives and solver masks."""

from fluid_simulation_tpu_torch.scene.masks import SceneMasks, build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    add_box, add_sphere, empty_obstacles)

__all__ = ["SceneMasks", "build_masks", "add_box", "add_sphere",
           "empty_obstacles"]
