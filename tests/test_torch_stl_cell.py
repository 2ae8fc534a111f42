"""The benchmark's STL scene (``windbench/scenes/stl.py``) and its cell
``t128_split_stl`` on the CPU: the scene is the mask that the port's own
loader gives for the reference ``main()``'s mesh (13,072 solid cells at
128x64x64) and the JAX package's loader gives too, a mesh that cannot be read raises instead of leaving an empty
tunnel, and the harness holds the resident split step on an STL mask to
the plain reference with every gap 0 (at 48x24x24, the mesh moved to fit
the smaller tunnel)."""

import os

import numpy as np
import pytest
import torch

from fluid_simulation_tpu_torch.config import SceneParams
from fluid_simulation_tpu_torch.scene import (
    empty_obstacles, load_stl_into_obstacles)
from windbench import harness, run, traffic

torch.set_num_threads(1)

CELL = "t128_split_stl"
SEED = 2 ** 31 + 2525
STL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "icosphere_r10.stl")
# the port's scene test's FLAGSHIP_SCENE: main()'s rotation and translate
# at scale 0.5, with the default engine (rasterize)
FLAGSHIP_SCENE = dict(stl_path=STL, scale=0.5, rot_x=90, translate_x=-16)


def test_cell_scene_is_the_loaders_mask():
    wl = traffic.load_json("workloads", CELL)
    cfg = traffic.load_json("configs", wl["config"])
    obs = traffic.scene(wl["scene"], cfg)
    want = load_stl_into_obstacles(SceneParams(**FLAGSHIP_SCENE),
                                   empty_obstacles(128, 64, 64))
    assert obs.dtype == np.float32 and np.array_equal(obs, want)
    assert int(obs.sum()) == 13072
    assert wl["scene"]["path"] == "tests/golden/icosphere_r10.stl"


def test_cell_scene_is_the_jax_packages_mask():
    """The benchmark's check feeds the program and the plain reference one
    field, so it cannot see the mask: the JAX package's loader holds it
    here, cell for cell, at the cell's own grid and transform."""
    from fluid_simulation_tpu.config import SceneParams as JaxSceneParams
    from fluid_simulation_tpu.scene import voxelize as jvox
    wl = traffic.load_json("workloads", CELL)
    cfg = traffic.load_json("configs", wl["config"])
    obs = traffic.scene(wl["scene"], cfg)
    want = jvox.load_stl_into_obstacles(
        JaxSceneParams(**FLAGSHIP_SCENE),
        empty_obstacles(cfg["width"], cfg["height"], cfg["depth"]),
        use_native=False)
    np.testing.assert_array_equal(obs, want)


@pytest.mark.parametrize("path", ["tests/golden/missing.stl", "tests"],
                         ids=["missing", "a_directory"])
def test_unreadable_mesh_raises(path):
    wl = traffic.load_json("workloads", CELL)
    cfg = traffic.load_json("configs", wl["config"])
    with pytest.raises(ValueError, match="no solid cell"):
        traffic.scene(dict(wl["scene"], path=path), cfg)


def test_stl_cell_is_correct_on_the_cpu():
    cfg = dict(traffic.load_json("configs", "tunnel128_split"), width=48,
               height=24, depth=24)
    wl = traffic.load_json("workloads", CELL)
    wl = dict(wl, scene=dict(wl["scene"], translate_x=-6), frame_steps=2)
    assert traffic.scene(wl["scene"], cfg).sum() > 0
    result, lines = run.execute(harness.benchmark(), CELL, SEED, 0.6, False,
                                torch.device("cpu"), workload=wl,
                                config=cfg)
    assert result["correct"], lines
    assert all(row["value"] == 0 for k, row in result["checks"].items()
               if k in harness.CHECKS), lines
