"""The port's scene layer against the JAX package: SceneParams, the STL
reader, the rasterizing and ray-parity voxelizers, and the reference main()'s
STL -> voxelize -> flow path held to the STL-flow golden.

The voxelizers are the same NumPy code on the same mesh, so masks agree
bitwise. The ray-parity engine runs at ``fine_divisor=40``: the reference's
200 takes about a minute in NumPy, too long for the CPU suite. The flow is
held to the JAX suite's thresholds for the same golden
(tests/test_golden_parity.py:148-188).
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from fluid_simulation_tpu.config import SceneParams as JaxSceneParams
from fluid_simulation_tpu.scene import stl as jstl
from fluid_simulation_tpu.scene import voxelize as jvox
from fluid_simulation_tpu_torch import SimParams, WindTunnel
from fluid_simulation_tpu_torch.config import SceneParams
from fluid_simulation_tpu_torch.convert import scene_params_from_json
from fluid_simulation_tpu_torch.convert import state_to_numpy
from fluid_simulation_tpu_torch.scene import (
    bounding_sphere_box, empty_obstacles, grid_mapping,
    load_stl_into_obstacles, read_stl, rotate_triangles, rotation_matrix,
    voxelize_rasterize, voxelize_ray_parity)

torch.set_num_threads(1)

CPU = "cpu"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
STL = os.path.join(GOLDEN_DIR, "icosphere_r10.stl")
# the reference main()'s rotation and translate (SURVEY.md:123-128) at
# scale 0.5, where the icosphere fits the flagship tunnel's cross-section
FLAGSHIP_SCENE = dict(stl_path=STL, scale=0.5, rot_x=90, translate_x=-16,
                      voxelizer="rasterize")
GOLDEN_SCENE = dict(stl_path=STL, scale=1.0, rot_x=30, rot_y=45, rot_z=60,
                    translate_x=2, translate_y=1, translate_z=-1)


def test_scene_params_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxSceneParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(SceneParams)]
    assert tf == jf
    jp = JaxSceneParams(**GOLDEN_SCENE, voxelizer="ray_parity")
    tp = scene_params_from_json(jp.to_json())
    assert tp == SceneParams(**GOLDEN_SCENE, voxelizer="ray_parity")
    assert tp.to_json() == jp.to_json()


def _write_ascii(path, tris):
    with open(path, "w") as fh:
        fh.write("solid t\n")
        for tri in tris:
            fh.write(" facet normal 0 0 0\n  outer loop\n")
            for v in tri:
                fh.write("   vertex " + " ".join(repr(float(c)) for c in v)
                         + "\n")
            fh.write("  endloop\n endfacet\n")
        fh.write("endsolid t\n")


def _write_binary(path, tris):
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for tri in tris:
            fh.write(struct.pack("<12fH", 0, 0, 0, *tri.reshape(-1), 0))


@pytest.mark.parametrize("fmt", ["repo", "ascii", "binary"])
def test_read_stl_matches_jax(tmp_path, fmt):
    path = STL
    if fmt != "repo":
        rng = np.random.default_rng(5)
        tris = rng.normal(size=(7, 3, 3)).astype(np.float32)
        path = str(tmp_path / f"mesh_{fmt}.stl")
        (_write_ascii if fmt == "ascii" else _write_binary)(path, tris)
    got, want = read_stl(path), jstl.read_stl(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if fmt != "repo":
        np.testing.assert_array_equal(got, tris)


def test_mesh_transforms_match_jax():
    tris = read_stl(STL)
    np.testing.assert_array_equal(rotation_matrix(30, 45, 60),
                                  jstl.rotation_matrix(30, 45, 60))
    for center in ("origin", "bbox_center"):
        got = rotate_triangles(tris, 30, 45, 60, center)
        want = jstl.rotate_triangles(tris, 30, 45, 60, center)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = bounding_sphere_box(tris, np.zeros(3, np.float32))
    want = jstl.bounding_sphere_box(tris, np.zeros(3, np.float32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        read_stl(STL + ".missing")


@pytest.mark.parametrize("dims,scene", [
    ((64, 32, 32), GOLDEN_SCENE),
    ((128, 64, 64), FLAGSHIP_SCENE),
])
def test_rasterize_matches_jax(dims, scene):
    scene = {**scene, "voxelizer": "rasterize"}
    got = load_stl_into_obstacles(SceneParams(**scene), empty_obstacles(*dims))
    want = jvox.load_stl_into_obstacles(JaxSceneParams(**scene),
                                        empty_obstacles(*dims),
                                        use_native=False)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_flagship_stl_scene_fits_the_tunnel():
    """The slice's STL scene: 13,072 solid cells, clear of every wall."""
    obs = load_stl_into_obstacles(SceneParams(**FLAGSHIP_SCENE),
                                  empty_obstacles(128, 64, 64))
    assert int(obs.sum()) == 13072
    z, y, x = np.nonzero(obs)
    assert (z.min(), z.max(), y.min(), y.max()) == (17, 46, 17, 46)
    assert (x.min(), x.max()) == (33, 62)


def test_rasterize_primitives_match_jax():
    """The engine below load_stl_into_obstacles, on grid-space triangles."""
    tris = read_stl(STL)
    rot, c = rotate_triangles(tris, 10, 20, 30)
    lo, hi, _ = bounding_sphere_box(tris, c)
    to_grid, scale = grid_mapping(lo, hi, c, 0.8, 40, 24, 20, (1, 0, 0))
    jto_grid, jscale = jvox.grid_mapping(lo, hi, c, 0.8, 40, 24, 20,
                                         (1, 0, 0))
    assert scale == jscale
    g = to_grid(rot.reshape(-1, 3)).reshape(-1, 3, 3).astype(np.float64)
    np.testing.assert_array_equal(g, jto_grid(rot.reshape(-1, 3)).reshape(
        -1, 3, 3).astype(np.float64))
    np.testing.assert_array_equal(voxelize_rasterize(g, 40, 24, 20),
                                  jvox.voxelize_rasterize(g, 40, 24, 20))


def test_ray_parity_matches_jax_numpy_engine():
    tris = read_stl(STL)
    rot, c = rotate_triangles(tris, 30, 45, 60)
    lo, hi, _ = bounding_sphere_box(tris, c)
    args = (rot, c, lo, hi, 1.0, 64, 32, 32, (2, 1, -1))
    got = voxelize_ray_parity(*args, seed=3, fine_divisor=40)
    want = jvox.voxelize_ray_parity(*args, seed=3, fine_divisor=40)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_load_failure_keeps_obstacles(capsys):
    obs = empty_obstacles(8, 4, 4)
    obs[2, 2, 2] = 1.0
    out = load_stl_into_obstacles(SceneParams(stl_path=STL + ".missing"), obs)
    np.testing.assert_array_equal(out, obs)
    assert "Failed to load STL" in capsys.readouterr().out
    with pytest.raises(ValueError, match="voxelizer"):
        load_stl_into_obstacles(SceneParams(stl_path=STL, voxelizer="x"), obs)


def _cube_stl(path, lo=-2.0, hi=2.0):
    """The cube of tests/test_native.py::_cube_stl, written to ``path``."""
    c = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], dtype=np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 1))
            for v in t:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))
    return str(path)


# the inputs on which the NumPy and the C++ engine differ by a cell
CUBE_SCENE = dict(voxelizer="ray_parity", rot_x=15, rot_y=25, rot_z=35,
                  scale=0.6)


@pytest.mark.parametrize("use_native,solids", [(True, 1708),
                                               (False, 1709)])
def test_ray_parity_loader_matches_jax_engines(tmp_path, use_native, solids):
    """The cube at 64x32x32: by default the port's loader gives the JAX
    loader's default mask (the C++ engine's, 1708 solids); with
    ``use_native=False`` the NumPy engine's 1709 (that engine equals the
    JAX one: ``test_ray_parity_matches_jax_numpy_engine``)."""
    from fluid_simulation_tpu.native import load_library
    try:
        load_library()
    except OSError:
        pytest.skip("the JAX package's native library is unavailable")
    path = _cube_stl(tmp_path / "cube.stl")
    got = load_stl_into_obstacles(SceneParams(stl_path=path, **CUBE_SCENE),
                                  empty_obstacles(64, 32, 32),
                                  use_native=use_native)
    if use_native:
        want = jvox.load_stl_into_obstacles(
            JaxSceneParams(stl_path=path, **CUBE_SCENE),
            empty_obstacles(64, 32, 32))
        np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == solids


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that cannot run is an error naming it, through the
    loader too: the port never falls back to the NumPy engine."""
    from fluid_simulation_tpu_torch.native import geometry
    monkeypatch.setattr(geometry, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(geometry, "CXX", str(tmp_path / "no-such-g++"))
    geometry.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-g"):
            geometry.build()
        with pytest.raises(RuntimeError, match="no-such-g"):
            load_stl_into_obstacles(
                SceneParams(stl_path=_cube_stl(tmp_path / "cube.stl"),
                            **CUBE_SCENE), empty_obstacles(16, 8, 8))
    finally:
        geometry.library.cache_clear()


def test_golden_stl_flow_end_to_end():
    """The reference main()'s path through the port: the golden's exact
    mask (the reference voxelizer jitters randomly, so its mask is the
    input), 20 gs_wavefront steps (about 10 s on one CPU thread), held to
    the JAX suite's thresholds for the same golden."""
    g = np.load(os.path.join(GOLDEN_DIR, "stl_flow_64x32x32.npz"))
    p = SimParams(width=int(g["W"]), height=int(g["H"]), depth=int(g["D"]),
                  solver="gs_wavefront")
    wt = WindTunnel(p, obstacles=np.asarray(g["obs"], np.float32),
                    device=CPU)
    assert not wt.params.empty_scene
    states, sums = [], []
    for _ in range(20):
        sums.append(float(wt.step().density_sum))
        states.append(state_to_numpy(wt.state))
    sums = np.array(sums, np.float64)
    # step-1 full-field parity (wavefront GS == sequential C++ at ulp)
    for i, key, atol in ((0, "vx_step1", 5e-6), (3, "dens_step1", 1e-8)):
        np.testing.assert_allclose(states[0][i], g[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert np.abs(states[4][3] - g["dens_step5"]).max() < 1e-5
    np.testing.assert_allclose(sums[:8], g["dens_sums"][:8], rtol=2e-4)
    np.testing.assert_allclose(sums, g["dens_sums"], rtol=3e-2)
    ref = g["vx_final"].astype(np.float64)
    m = states[-1][0].astype(np.float64)
    assert abs(np.abs(m).mean() - np.abs(ref).mean()) \
        / (np.abs(ref).mean() + 1e-12) < 0.08
    # solid cells stay exactly zero
    solid = np.asarray(g["obs"]) >= 0.5
    for f in states[-1]:
        assert not f[solid].any()
