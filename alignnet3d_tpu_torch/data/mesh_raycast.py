"""Triangle-mesh LiDAR scanning — the full Embree-equivalent path.

Counterpart of ``alignnet3d_tpu/data/mesh_raycast.py``. Binds the port's
own BVH raycaster (``csrc/raycast.cpp``, ABI version 1) so that arbitrary
triangle meshes (e.g. ModelNet .off files) can be scanned with the same
sensor model as the reference (tp_utils/pointcloud.py:1119-1138:
trimesh.ray_pyembree). Mesh normalization matches the reference Mesh class
(pointcloud.py:447-465): translate by the bounds midpoint, scale so the
largest |bound| becomes 0.5.

The library is host code, built at first use by ``g++`` into the
checkout's gitignored ``build/raycast/`` under a name hashed from the
source and the flags, as ``data/native_loader.py`` builds the batch
assembler: ``-O3 -fPIC -shared -std=c++17`` and no ``-march=native``, so
it gives the same bits on every x86-64 host (the JAX package's build uses
``-march=native``; a contracted FMA there can move a hit distance by an
ulp). Without g++, ``scan_mesh`` falls back to the numpy Moller-Trumbore
sweep, as the JAX package does.

Includes a pure-python .off loader (ModelNet's format) and a
``MeshScene`` mirroring ``SyntheticBoxScene`` for mesh-based datasets.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from alignnet3d_tpu_torch.data.native_loader import build_host_library
from alignnet3d_tpu_torch.data.synthetic import (
    RandomTransform,
    distance_noise,
    lidar_rays,
)
from alignnet3d_tpu_torch.geometry import np_to_str

logger = logging.getLogger("alignnet3d_tpu_torch")

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raycast.cpp"
ABI_VERSION = 1


def build() -> Path:
    """Compile the raycaster if its library is missing; return its path."""
    return build_host_library(SOURCE, "raycast")


@functools.cache
def get_lib():
    """Load (building if needed) the raycaster; None if unavailable."""
    try:
        path = build()
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug(f"native raycast build failed: {e}")
        logger.info("native raycast unavailable; using numpy sweep")
        return None
    lib = ctypes.CDLL(str(path))
    lib.raycast_abi_version.restype = ctypes.c_int
    if lib.raycast_abi_version() != ABI_VERSION:
        logger.warning("native raycast ABI mismatch; using numpy sweep")
        return None
    lib.raycast_build.restype = ctypes.c_void_p
    lib.raycast_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.raycast_free.argtypes = [ctypes.c_void_p]
    lib.raycast_first_hits.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.raycast_first_hits.restype = None
    return lib


def load_off(path: str):
    """(vertices (V,3) f32, faces (F,3) i32) from an OFF file; polygon
    faces are fan-triangulated."""
    with open(path) as f:
        tokens = f.read().split()
    idx = 0
    header = tokens[idx]
    if header.startswith("OFF") and len(header) > 3:
        # 'OFF123 456 0' glued header variant seen in ModelNet
        tokens[idx] = header[3:]
    elif header == "OFF":
        idx += 1
    nv, nf = int(tokens[idx]), int(tokens[idx + 1])
    idx += 3  # skip edge count
    verts = np.array(tokens[idx: idx + 3 * nv], np.float32).reshape(nv, 3)
    idx += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[idx]); idx += 1
        poly = [int(tokens[idx + j]) for j in range(k)]
        idx += k
        for j in range(1, k - 1):
            faces.append([poly[0], poly[j], poly[j + 1]])
    return verts, np.asarray(faces, np.int32)


class Mesh:
    """Normalized triangle mesh with a native BVH (reference Mesh,
    pointcloud.py:447-465)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        vertices = np.asarray(vertices, np.float32)
        lo, hi = vertices.min(axis=0), vertices.max(axis=0)
        vertices = vertices - (lo + hi) / 2.0
        max_len = np.max(np.abs([vertices.min(axis=0), vertices.max(axis=0)]))
        if max_len > 0:
            vertices = vertices / (max_len * 2.0)
        self.vertices = vertices
        self.faces = np.ascontiguousarray(faces, np.int32)

    @classmethod
    def from_off(cls, path: str) -> "Mesh":
        return cls(*load_off(path))

    def posed(self, scale: float, pose: np.ndarray) -> np.ndarray:
        v = self.vertices * scale
        return (v @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)


def scan_mesh(vertices: np.ndarray, faces: np.ndarray,
              dirs: np.ndarray | None = None, max_range: float = 120.0):
    """First-hit points of origin LiDAR rays against a posed mesh.

    Uses the native BVH when available; falls back to a (slow) vectorized
    numpy Moller-Trumbore sweep otherwise.
    """
    if dirs is None:
        dirs = lidar_rays()
    dirs = np.ascontiguousarray(dirs, np.float32)
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lib = get_lib()
    if lib is not None:
        handle = lib.raycast_build(
            vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(vertices),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(faces),
        )
        try:
            origins = np.zeros_like(dirs)
            out = np.empty(len(dirs), np.float32)
            lib.raycast_first_hits(
                handle,
                origins.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(dirs), max_range,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        finally:
            lib.raycast_free(handle)
        hit = out > 0
        return dirs[hit] * out[hit, None]
    return _scan_mesh_numpy(vertices, faces, dirs, max_range)


def _scan_mesh_numpy(vertices, faces, dirs, max_range):
    """Fallback: batched Moller-Trumbore over all (ray, tri) pairs in
    chunks. O(rays * tris) — fine for small test meshes only."""
    v0 = vertices[faces[:, 0]].astype(np.float64)
    e1 = vertices[faces[:, 1]].astype(np.float64) - v0
    e2 = vertices[faces[:, 2]].astype(np.float64) - v0
    best = np.full(len(dirs), np.inf)
    chunk = max(1, 2_000_000 // max(1, len(faces)))
    for s in range(0, len(dirs), chunk):
        d = dirs[s: s + chunk].astype(np.float64)  # (R, 3)
        p = np.cross(d[:, None, :], e2[None, :, :])  # (R, T, 3)
        det = np.einsum("tj,rtj->rt", e1, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
            srel = -v0[None, :, :]  # origin 0
            u = np.einsum("rtj,rtj->rt", srel, p) * inv_det
            q = np.cross(srel, e1[None, :, :])
            v = np.einsum("rj,rtj->rt", d, q) * inv_det
            t = np.einsum("tj,rtj->rt", e2, q) * inv_det
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (u <= 1) & (v >= 0) & \
            (u + v <= 1) & (t > 1e-6) & (t <= max_range)
        t = np.where(ok, t, np.inf)
        best[s: s + chunk] = t.min(axis=1)
    hit = np.isfinite(best)
    return dirs[hit] * best[hit, None]


def procedural_car_mesh(rng: np.random.Generator):
    """A watertight low-poly car mesh (prism over a randomized side
    profile): bottom, nose, hood, windshield, roof, rear window, tail.

    Stands in for the reference's ModelNet car meshes
    (pointcloud.py:1077-1087, 1119-1138) in environments without the
    ModelNet files; each call draws one silhouette, so a fixed set of
    calls forms a discrete shape library like the reference's 50 meshes.
    Returns (vertices (V, 3) float32, faces (F, 3) int32).
    """
    nose_h = rng.uniform(0.28, 0.45)
    hood_h = rng.uniform(0.48, 0.62)
    windshield_x = rng.uniform(0.58, 0.70)
    roof_front_x = rng.uniform(0.44, 0.56)
    roof_rear_x = rng.uniform(0.18, 0.30)
    tail_x = rng.uniform(0.02, 0.10)
    tail_h = rng.uniform(0.55, 0.95)       # sedan .55 .. hatchback .95
    width = rng.uniform(0.38, 0.48)
    # side profile, counterclockwise in (x, z); front of car at x=1
    profile = np.array([
        [0.00, 0.06],
        [1.00, 0.06],
        [1.00, nose_h],
        [windshield_x, hood_h],
        [roof_front_x, 1.00],
        [roof_rear_x, 1.00],
        [tail_x, tail_h],
        [0.00, tail_h * 0.9],
    ], np.float32)
    k = len(profile)
    half_w = width / 2.0
    left = np.column_stack([profile[:, 0], np.full(k, -half_w),
                            profile[:, 1]])
    right = np.column_stack([profile[:, 0], np.full(k, half_w),
                             profile[:, 1]])
    vertices = np.concatenate([left, right]).astype(np.float32)

    faces = []
    # side faces: fan triangulation (the profile is star-shaped)
    for i in range(1, k - 1):
        faces.append([0, i, i + 1])              # left side
        faces.append([k, k + i + 1, k + i])      # right side
    # band quads connecting the two sides along each profile edge
    for i in range(k):
        j = (i + 1) % k
        faces.append([i, j, k + j])
        faces.append([i, k + j, k + i])
    return vertices, np.asarray(faces, np.int32)


def generate_mesh_dataset(basepath: str, num_train: int, num_val: int,
                          seed: int = 0, vres: int = 64, hres: int = 1500,
                          polar_dist_range=(4, 20), library_size: int = 50,
                          scale_range=(3.5, 5.5), min_points: int = 5):
    """Generate a full dataset directory by ray-casting procedural car
    meshes — the mesh-based analogue of synthetic.generate_dataset and
    of the reference's Embree pipeline (pointcloud.py:1119-1138).

    A discrete ``library_size``-mesh library is drawn once from ``seed``
    (matching the reference's 50 fixed ModelNet meshes); each scene picks
    one mesh, a scale, and a random planar pose pair.
    """
    lib_rng = np.random.default_rng(seed ^ 0x5EED)
    library = [Mesh(*procedural_car_mesh(lib_rng))
               for _ in range(library_size)]

    os.makedirs(os.path.join(basepath, "split"), exist_ok=True)
    n_total = num_train + num_val
    written = 0
    attempt = 0
    indices = []
    while written < n_total:
        scene_seed = seed * 1_000_003 + attempt
        attempt += 1
        rng = np.random.default_rng(scene_seed)
        mesh_id = int(rng.integers(0, library_size))
        scale = float(rng.uniform(*scale_range))
        scene = MeshScene(
            library[mesh_id], seed=scene_seed, mesh_scale=scale,
            polar_dist_range=polar_dist_range, vres=vres, hres=hres,
            meta_extra={"mesh_id": mesh_id, "object_type": "car"},
        )
        scene.generate_pointcloud()
        if min(len(pc) for pc in scene.pointclouds) < min_points:
            continue
        scene.save(basepath, written)
        indices.append(written)
        written += 1
    train_idx = indices[:num_train]
    val_idx = indices[num_train:]
    for name, idxs in (("train", train_idx), ("val", val_idx)):
        with open(f"{basepath}/split/{name}.txt", "w") as f:
            f.write("\n".join(str(i) for i in idxs) + "\n")
    return train_idx, val_idx


class MeshScene:
    """Mesh-based scene sample — ``SyntheticBoxScene`` with a real mesh
    (reference SyntheticScene + generate_pointcloud_embree,
    pointcloud.py:1055-1148)."""

    def __init__(self, mesh: Mesh, seed: int, mesh_scale: float = 6.0,
                 polar_dist_range=(4, 20), vres=64, hres=1500,
                 version: str = "mesh-v1", meta_extra: dict | None = None):
        self.mesh = mesh
        self.rng = np.random.default_rng(seed)
        self.transform = RandomTransform(polar_dist_range, self.rng)
        self.mesh_scale = mesh_scale
        self.vres, self.hres = vres, hres
        self.pointclouds = None
        self.additional_meta = {
            "version": version, "seed": int(seed),
            "mesh_scale": float(mesh_scale),
            **(meta_extra or {}),
        }

    def generate_pointcloud(self, add_noise: bool = True, sigma: float = 0.05,
                            clip: float = 0.05):
        dirs = lidar_rays(self.vres, self.hres)
        clouds = []
        for pose in (self.transform.transform_start,
                     self.transform.transform_end):
            posed = self.mesh.posed(self.mesh_scale, pose)
            pts = scan_mesh(posed, self.mesh.faces, dirs)
            if add_noise and len(pts):
                pts = distance_noise(pts, pose[:3, 3], self.rng, sigma, clip)
            clouds.append(np.asarray(pts, np.float32))
        self.pointclouds = clouds

    def save(self, basepath: str, scene_idx: int):
        import json

        assert self.pointclouds is not None
        for sub in ("meta", "pointcloud1", "pointcloud2"):
            os.makedirs(os.path.join(basepath, sub), exist_ok=True)
        for k, pc in enumerate(self.pointclouds):
            np.save(f"{basepath}/pointcloud{k + 1}/{str(scene_idx).zfill(8)}",
                    pc)
        t = self.transform
        data = {
            "start_position": np_to_str(t.start_position),
            "start_angle": float(t.start_angle),
            "end_position": np_to_str(t.end_position),
            "end_angle": float(t.end_angle),
            "translation": np_to_str(t.translation),
            "rel_angle": float(t.rel_angle),
            **self.additional_meta,
        }
        with open(f"{basepath}/meta/{str(scene_idx).zfill(8)}.json", "w") as f:
            json.dump(data, f)
