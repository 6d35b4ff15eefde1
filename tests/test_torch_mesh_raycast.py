"""The port's mesh raycaster (``csrc/raycast.cpp`` through
``alignnet3d_tpu_torch.data.mesh_raycast``) against its numpy sweep and
against the JAX package's ``scan_mesh``; the OFF loader, mesh
normalisation, the procedural car library and ``generate_mesh_dataset``
against the JAX package's.

Tolerances. Both native builds and the numpy sweep run Moller-Trumbore;
the libraries in float32, the sweep in float64, and the JAX package's
library is built with ``-march=native``, where the compiler may contract a
product and a sum into an FMA that the port's build (no ``-march``) rounds
twice. A hit distance then moves by a few float32 ulps: POINT_ATOL (1e-4
m) bounds a hit point's gap at these ranges (< 25 m; the largest seen is
4.7e-5 m). A grazing ray that one side hits and the other misses would
change a cloud's size; at the shapes tested here no ray does, so the hit
counts are held equal."""

import json
import os

import numpy as np
import pytest

from test_mesh_raycast import _box_mesh

from alignnet3d_tpu.data import mesh_raycast as jmr
from alignnet3d_tpu_torch.data import mesh_raycast as mr
from alignnet3d_tpu_torch.data import native_loader
from alignnet3d_tpu_torch.data.synthetic import lidar_rays

POINT_ATOL = 1e-4


def _posed_car(seed, yaw, dist=8.0, scale=4.5):
    m = mr.Mesh(*mr.procedural_car_mesh(np.random.default_rng(seed)))
    c, s = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4)
    pose[:2, :2] = [[c, -s], [s, c]]
    pose[:3, 3] = [dist, 2.0, 0.0]
    return m.posed(scale, pose), m.faces


@pytest.fixture(scope="module")
def lib():
    lib = mr.get_lib()
    assert lib is not None, "g++ could not build csrc/raycast.cpp"
    return lib


def test_the_port_builds_its_own_library(lib):
    """The port loads its g++ build of ``csrc/raycast.cpp`` under
    ``build/raycast/``, never the JAX package's ``native/`` library."""
    path = native_loader.host_library_path(mr.SOURCE, "raycast")
    assert path.exists() and path.parent.name == "raycast"
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert lib.raycast_abi_version() == mr.ABI_VERSION == 1
    with open("/proc/self/maps") as f:
        assert str(path) in f.read()


@pytest.mark.parametrize("case", ["box", "car0", "car1", "car2"])
def test_native_matches_numpy_sweep(lib, case):
    if case == "box":
        verts, faces = _box_mesh(center=(0, 8, 0))
    else:
        seed = int(case[-1])
        verts, faces = _posed_car(seed, yaw=1.3 * seed - 2.0)
    dirs = lidar_rays(16, 360).astype(np.float32)
    got = mr.scan_mesh(verts, faces, dirs)
    ref = mr._scan_mesh_numpy(verts, faces, dirs, 120.0)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, atol=POINT_ATOL, rtol=0)


@pytest.mark.parametrize("yaw", [-3.0, -1.0, 0.0, 1.0, 2.0])
def test_native_matches_jax_scan_mesh(lib, yaw):
    verts, faces = _posed_car(7, yaw)
    dirs = lidar_rays(32, 720).astype(np.float32)
    got = mr.scan_mesh(verts, faces, dirs)
    ref = jmr.scan_mesh(verts, faces, dirs)
    assert len(got) == len(ref) > 50
    np.testing.assert_allclose(got, ref, atol=POINT_ATOL, rtol=0)


def test_numpy_sweep_is_the_jax_sweep():
    verts, faces = _posed_car(3, 0.7)
    dirs = lidar_rays(8, 180).astype(np.float32)
    np.testing.assert_array_equal(
        mr._scan_mesh_numpy(verts, faces, dirs, 120.0),
        jmr._scan_mesh_numpy(verts, faces, dirs, 120.0))


def test_without_the_library_scan_mesh_sweeps_in_numpy(monkeypatch):
    verts, faces = _box_mesh(center=(0, 6, 0))
    dirs = lidar_rays(8, 120).astype(np.float32)
    monkeypatch.setattr(mr, "get_lib", lambda: None)
    np.testing.assert_array_equal(
        mr.scan_mesh(verts, faces, dirs),
        mr._scan_mesh_numpy(verts, faces, dirs, 120.0))


def test_off_loader_like_jax(tmp_path):
    verts, faces = _box_mesh()
    path = tmp_path / "box.off"
    lines = ["OFF", f"{len(verts)} {len(faces)} 0"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in verts]
    lines += ["3 " + " ".join(str(i) for i in f) for f in faces]
    path.write_text("\n".join(lines) + "\n")
    v2, f2 = mr.load_off(str(path))
    np.testing.assert_allclose(v2, verts, atol=1e-6)
    np.testing.assert_array_equal(f2, faces)
    # a glued ModelNet header and a quad face (fan-triangulated)
    glued = tmp_path / "quad.off"
    glued.write_text("OFF4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    for p in (path, glued):
        for got, ref in zip(mr.load_off(str(p)), jmr.load_off(str(p))):
            np.testing.assert_array_equal(got, ref)
    assert mr.load_off(str(glued))[1].shape == (2, 3)
    m = mr.Mesh.from_off(str(path))
    np.testing.assert_array_equal(m.vertices, jmr.Mesh.from_off(str(path)).vertices)


def test_mesh_normalization_like_jax():
    verts, faces = _box_mesh(half=(2.0, 4.0, 1.0), center=(5.0, 5.0, 5.0))
    mesh, ref = mr.Mesh(verts, faces), jmr.Mesh(verts, faces)
    np.testing.assert_array_equal(mesh.vertices, ref.vertices)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    assert np.max(np.abs(mesh.vertices)) == pytest.approx(0.5, abs=1e-6)
    pose = np.eye(4)
    pose[:3, 3] = [3.0, -1.0, 0.5]
    np.testing.assert_array_equal(mesh.posed(4.0, pose), ref.posed(4.0, pose))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_procedural_car_mesh_bit_equal(seed):
    got = mr.procedural_car_mesh(np.random.default_rng(seed))
    ref = jmr.procedural_car_mesh(np.random.default_rng(seed))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def _dataset_files(base):
    return sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, _, fs in os.walk(base) for f in fs)


def assert_mesh_datasets_agree(got_dir, ref_dir):
    """Scene by scene: the same files, meta and splits equal, each cloud
    of the same size and within POINT_ATOL (the same noise draws follow
    the same number of hits)."""
    files = _dataset_files(ref_dir)
    assert _dataset_files(got_dir) == files
    for rel in files:
        g, r = os.path.join(got_dir, rel), os.path.join(ref_dir, rel)
        if rel.endswith(".npy"):
            a, b = np.load(g), np.load(r)
            assert a.shape == b.shape and a.dtype == b.dtype, rel
            np.testing.assert_allclose(a, b, atol=POINT_ATOL, rtol=0,
                                       err_msg=rel)
        elif rel.endswith(".json"):
            assert json.load(open(g)) == json.load(open(r)), rel
        else:
            assert open(g).read() == open(r).read(), rel


def test_generate_mesh_dataset_like_jax(tmp_path):
    kw = dict(num_train=5, num_val=3, seed=1, vres=16, hres=360,
              library_size=4)
    got = mr.generate_mesh_dataset(str(tmp_path / "port"), **kw)
    ref = jmr.generate_mesh_dataset(str(tmp_path / "jax"), **kw)
    assert got == ref
    assert_mesh_datasets_agree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_mesh_scene_like_jax(tmp_path):
    verts, faces = _box_mesh()
    kw = dict(seed=3, mesh_scale=6.0, vres=24, hres=360,
              meta_extra={"mesh_id": 0})
    scene = mr.MeshScene(mr.Mesh(verts, faces), **kw)
    ref = jmr.MeshScene(jmr.Mesh(verts, faces), **kw)
    scene.generate_pointcloud()
    ref.generate_pointcloud()
    assert all(len(pc) > 5 for pc in scene.pointclouds)
    scene.save(str(tmp_path / "port"), 0)
    ref.save(str(tmp_path / "jax"), 0)
    assert_mesh_datasets_agree(str(tmp_path / "port"), str(tmp_path / "jax"))
