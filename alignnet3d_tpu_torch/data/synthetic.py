"""Synthetic LiDAR scans of randomly posed objects, for smoke runs and
tests of the port.

The port's own copy of the scene generator of
``alignnet3d_tpu/data/synthetic.py`` (``SyntheticBoxScene`` and what it
needs), with the same numpy RNG calls in the same order, so one seed gives
bit-equal clouds in both packages. An analytic ray/oriented-box
intersector stands in for the reference's Embree ray caster of ModelNet
meshes, with the reference's sensor model (64 beams, 26.9 deg vertical
field, 4500 azimuth steps; tp_utils/pointcloud.py:945-971), pose sampler
(``RandomTransform``, pointcloud.py:520-556) and distance-scaled clipped
gaussian noise (pointcloud.py:1133-1136).
"""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.geometry import get_mat_angle

VRES = 64
VFOV_DEG = 26.9
HRES = 4500


def lidar_rays(vres: int = VRES, hres: int = HRES, vfov: float = VFOV_DEG):
    """Unit ray directions of the spinning LiDAR at the origin: elevation
    linspace over +-vfov/2, azimuth 360/hres apart, [sin h, cos h, tan v]."""
    v = np.linspace(-vfov / 2.0, vfov / 2.0, vres)
    h = -180.0 + 360.0 / hres * np.arange(hres)
    hh, vv = np.meshgrid(h, v)
    x = np.sin(np.deg2rad(hh))
    y = np.cos(np.deg2rad(hh))
    z = np.tan(np.deg2rad(vv))
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def ray_box_t(dirs: np.ndarray, box_to_world: np.ndarray,
              half_extents: np.ndarray, box_offset=None,
              max_range: float = 120.0):
    """Per-ray first-hit parameter against one oriented box (slab test).
    ``box_offset`` is the part's centre in the object frame. Returns
    (t, hit)."""
    R = box_to_world[:3, :3]
    t = box_to_world[:3, 3].copy()
    if box_offset is not None:
        t = t + R @ np.asarray(box_offset, np.float64)
    o = -R.T @ t
    d = dirs @ R  # rows = R^T @ dir
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t1 = (-half_extents - o) * inv
        t2 = (half_extents - o) * inv
    tmin = np.nanmax(np.minimum(t1, t2), axis=1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tmax >= tmin) & (tmax >= 0) & (tmin <= max_range)
    tfirst = np.where(tmin > 0, tmin, tmax)  # inside-box rays exit instead
    return tfirst, hit


def ray_parts_t(dirs: np.ndarray, pose: np.ndarray, parts,
                max_range: float = 120.0):
    """Per-ray nearest hit over all (offset, half_extents) parts of an
    object. Returns (t, hit)."""
    best_t = np.full(len(dirs), np.inf)
    any_hit = np.zeros(len(dirs), bool)
    for offset, half in parts:
        tfirst, hit = ray_box_t(dirs, pose, np.asarray(half), offset,
                                max_range)
        better = hit & (tfirst < best_t)
        best_t = np.where(better, tfirst, best_t)
        any_hit |= hit
    return best_t, any_hit


def distance_noise(points: np.ndarray, centroid: np.ndarray,
                   rng: np.random.Generator, sigma: float = 0.05,
                   clip: float = 0.05) -> np.ndarray:
    """Distance-scaled clipped gaussian measurement noise."""
    strength = max(0.005, sigma * float(np.linalg.norm(centroid)) / 80.0)
    noise = np.clip(strength * rng.standard_normal(points.shape), -clip, clip)
    return points + noise


class RandomTransform:
    """Planar pose-pair sampler: heading uniform(-pi, pi), speed
    uniform(0, 1), yaw change uniform(-pi/2, pi/2), polar placement
    uniform in ``polar_dist_range``."""

    def __init__(self, polar_dist_range, rng: np.random.Generator):
        self.angle = rng.uniform(-np.pi, np.pi)
        self.velocity = rng.uniform(0, 1)
        self.translation = (
            np.array([np.sin(self.angle), np.cos(self.angle), 0.0])
            * self.velocity
        )
        self.rel_angle = rng.uniform(-np.pi, np.pi) / 2.0

        polar_angle = rng.uniform(-np.pi, np.pi)
        polar_distance = rng.uniform(*polar_dist_range)
        self.start_position = (
            np.array([np.sin(polar_angle), np.cos(polar_angle), 0.0])
            * polar_distance
        )
        self.start_angle = rng.uniform(-np.pi, np.pi)
        self.end_position = self.start_position + self.translation
        self.end_angle = self.start_angle + self.rel_angle

        self.transform_start = get_mat_angle(self.start_position, self.start_angle)
        self.rel_transform = get_mat_angle(self.translation, self.rel_angle)
        self.transform_end = get_mat_angle(self.end_position, self.end_angle)


CAR_ASPECT = np.array([0.85, 2.0, 0.65])  # w/2, l/2, h/2 per unit scale / 4.4
PERSON_ASPECT = np.array([0.25, 0.25, 0.88])


def make_object_parts(cat: str, mesh_scale: float, rng: np.random.Generator):
    """Multi-part box shape of a category in the object frame (+y =
    forward), a deterministic function of the rng state. Cars are front/back
    asymmetric (cabin toward the rear, hood step at the front). Returns a
    list of (centre offset (3,), half extents (3,))."""
    if cat == "car":
        aspect = CAR_ASPECT * rng.uniform(0.88, 1.12, 3)
        half = aspect / aspect.max() * 0.5 * mesh_scale
        w2, l2, h2 = half
        body = (np.zeros(3), np.array([w2, l2, h2 * 0.62]))
        cabin_len = l2 * rng.uniform(0.38, 0.52)
        cabin_shift = -l2 * rng.uniform(0.12, 0.3)
        cabin = (
            np.array([0.0, cabin_shift, h2 * 0.45]),
            np.array([w2 * 0.9, cabin_len, h2 * 0.55]),
        )
        hood = (
            np.array([0.0, l2 * 0.8, -h2 * 0.25]),
            np.array([w2 * 0.95, l2 * 0.2, h2 * 0.35]),
        )
        return [body, cabin, hood]
    if cat == "person":
        aspect = PERSON_ASPECT * rng.uniform(0.9, 1.1, 3)
        half = aspect / aspect.max() * 0.5 * mesh_scale
        w2, l2, h2 = half
        torso = (np.zeros(3), np.array([w2, l2, h2 * 0.8]))
        head = (
            np.array([0.0, l2 * 0.15, h2 * 0.85]),
            np.array([w2 * 0.55, l2 * 0.55, h2 * 0.2]),
        )
        return [torso, head]
    raise ValueError(f"unknown category {cat!r}")


class SyntheticBoxScene:
    """One sample: an object observed at two poses by the LiDAR at the
    origin. The shape is one of 50 fixed layouts per category (``mesh_id``);
    only the pose changes between the two views. ``hard`` adds a partial
    occluder (with clutter) and a truncating half-plane."""

    def __init__(self, seed: int, version: str = "box-v1",
                 polar_dist_range=(4, 20),
                 obj_size_range=dict(car=(6, 6), person=(1.6, 2.0)),
                 allow_persons: bool = False, person_prob: float = 0.2,
                 second_object_set: bool = False,
                 vres: int = VRES, hres: int = HRES,
                 hard: bool = False):
        self.seed = seed
        self.version = version
        self.rng = np.random.default_rng(seed)
        self.transform = RandomTransform(polar_dist_range, self.rng)
        self.cat = "car"
        if allow_persons and self.rng.random() < person_prob:
            self.cat = "person"
        self.mesh_scale = self.rng.uniform(*obj_size_range[self.cat])
        id_base = 54 if second_object_set else 1
        self.mesh_id = int(self.rng.integers(id_base, id_base + 50))
        layout_rng = np.random.default_rng(
            self.mesh_id * 1009 + (0 if self.cat == "car" else 7919)
        )
        self.parts = make_object_parts(self.cat, self.mesh_scale, layout_rng)
        self.half_extents = self.parts[0][1]
        self.vres = vres
        self.hres = hres
        self.pointclouds = None

        self.hard = bool(hard)
        self.occluder_pose = None
        self.occluder_parts = None
        self.trunc_normal = None
        self.trunc_offset = None
        if hard:
            r = self.rng
            dist = float(np.linalg.norm(self.transform.start_position[:2]))
            if r.random() < 0.65 and dist >= 8.0:
                # partial occluder between the sensor and the target, placed
                # by where its shadow edge falls across the target
                f = r.uniform(max(0.45, 3.5 / dist), 0.8)
                mid = self.transform.start_position * f
                fwd = mid[:2] / max(np.linalg.norm(mid[:2]), 1e-6)
                side = np.array([-fwd[1], fwd[0]])
                occ_yaw = r.uniform(-np.pi, np.pi)
                tgt_half_ang = 1.8 / dist
                occ_half_ang = 3.0 / (f * dist)
                sgn = float(r.choice([-1.0, 1.0]))
                edge_ang = sgn * tgt_half_ang * r.uniform(-0.6, 0.8)
                center_ang = edge_ang + sgn * occ_half_ang
                lat = np.tan(center_ang) * f * dist
                pos = np.array([mid[0] + side[0] * lat,
                                mid[1] + side[1] * lat, 0.0])
                self.occluder_pose = get_mat_angle(pos, occ_yaw)
                occ_rng = np.random.default_rng(
                    int(r.integers(1, 50)) * 1009)
                self.occluder_parts = make_object_parts("car", 6.0, occ_rng)
            if r.random() < 0.5:
                # half-plane beyond the object centre, shaving 15-65% of one
                # side's extent
                theta = r.uniform(-np.pi, np.pi)
                self.trunc_normal = np.array(
                    [np.cos(theta), np.sin(theta), 0.0])
                span = self.mesh_scale * 0.5
                self.trunc_offset = (
                    float(self.trunc_normal[:2]
                          @ self.transform.start_position[:2])
                    + span * r.uniform(0.35, 0.85)
                )

        self.additional_meta = {
            "version": self.version,
            "seed": int(self.seed),
            "mesh_id": self.mesh_id,
            "mesh_scale": float(self.mesh_scale),
            "cat": self.cat,
        }
        if hard:
            self.additional_meta["hard"] = {
                "occluded": self.occluder_pose is not None,
                "truncated": self.trunc_normal is not None,
            }

    def generate_pointcloud(self, add_noise: bool = True, sigma: float = 0.05,
                            clip: float = 0.05, clutter_radius: float = 2.5):
        dirs = lidar_rays(self.vres, self.hres)
        occ_t = occ_hit = None
        if self.occluder_pose is not None:
            # the occluder is static: one trace serves both views
            occ_t, occ_hit = ray_parts_t(dirs, self.occluder_pose,
                                         self.occluder_parts)
        clouds = []
        for pose in (self.transform.transform_start, self.transform.transform_end):
            t, hit = ray_parts_t(dirs, pose, self.parts)
            if occ_t is not None:
                hit = hit & ~(occ_hit & (occ_t < t))
            pts = dirs[hit] * t[hit, None]
            if self.hard and occ_t is not None:
                # occluder returns near the target leak into the crop
                opts = dirs[occ_hit] * occ_t[occ_hit, None]
                near = (np.linalg.norm(opts[:, :2] - pose[:2, 3][None],
                                       axis=1) < clutter_radius)
                if near.any():
                    pts = np.concatenate([pts, opts[near]], axis=0)
            if self.trunc_normal is not None and len(pts):
                keep = pts @ self.trunc_normal <= self.trunc_offset
                pts = pts[keep]
            if add_noise and len(pts):
                pts = distance_noise(pts, pose[:3, 3], self.rng, sigma, clip)
            clouds.append(np.asarray(pts, dtype=np.float32))
        self.pointclouds = clouds
