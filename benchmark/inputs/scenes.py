"""Seeded synthetic LiDAR pairs: the benchmark's frozen box-scene generator.

A frozen copy of the car scenes of ``alignnet3d_tpu_torch/data/synthetic.py``
(``SyntheticBoxScene`` without the hard variant, ``lidar_rays``, the pose
sampler and the distance-scaled noise), with the same numpy calls in the
same order, so that a scene seed gives the clouds that the port's generator
gives. It is kept here so that the benchmark's inputs do not move when the
program's generator does; ``GENERATOR_VERSION`` names it in cache keys.

An object (a car of three boxes, 6 m scale) is scanned at two poses by a
64 x 4500 ray LiDAR at the origin: 942 to about 88,000 points a cloud. The
labels are the dataset layout's (translation, rel_angle, start/end
position and angle).
"""

from __future__ import annotations

import json
import os

import numpy as np

GENERATOR_VERSION = "box-v1"
CAR_ASPECT = np.array([0.85, 2.0, 0.65])
MIN_POINTS = 5  # a scene whose views have fewer hits is skipped


def get_mat_angle(translation=None, rotation=None,
                  rotation_center=np.array([0.0, 0.0, 0.0])) -> np.ndarray:
    """4x4 yaw transform ``T(c + t) Rz(a) T(-c)``, float64."""
    center = np.asarray(rotation_center, dtype=np.float64).reshape(3)
    mat = np.eye(4)
    if rotation is not None:
        a = float(np.asarray(rotation).reshape(-1)[0])
        c, s = np.cos(a), np.sin(a)
        mat[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    mat[:3, 3] = center - mat[:3, :3] @ center
    if translation is not None:
        mat[:3, 3] += np.asarray(translation, dtype=np.float64).reshape(3)
    return mat


def lidar_rays(vres: int, hres: int, vfov: float = 26.9) -> np.ndarray:
    v = np.linspace(-vfov / 2.0, vfov / 2.0, vres)
    h = -180.0 + 360.0 / hres * np.arange(hres)
    hh, vv = np.meshgrid(h, v)
    return np.stack([np.sin(np.deg2rad(hh)), np.cos(np.deg2rad(hh)),
                     np.tan(np.deg2rad(vv))], axis=-1).reshape(-1, 3)


def _ray_box_t(dirs, box_to_world, half_extents, box_offset,
               max_range=120.0):
    R = box_to_world[:3, :3]
    t = box_to_world[:3, 3].copy() + R @ np.asarray(box_offset, np.float64)
    o = -R.T @ t
    d = dirs @ R
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t1 = (-half_extents - o) * inv
        t2 = (half_extents - o) * inv
    tmin = np.nanmax(np.minimum(t1, t2), axis=1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tmax >= tmin) & (tmax >= 0) & (tmin <= max_range)
    return np.where(tmin > 0, tmin, tmax), hit


def _ray_parts_t(dirs, pose, parts):
    best_t = np.full(len(dirs), np.inf)
    any_hit = np.zeros(len(dirs), bool)
    for offset, half in parts:
        tfirst, hit = _ray_box_t(dirs, pose, np.asarray(half), offset)
        better = hit & (tfirst < best_t)
        best_t = np.where(better, tfirst, best_t)
        any_hit |= hit
    return best_t, any_hit


def _may_hit(azimuth, centre, radius):
    """The rays whose azimuth lies within the object's bounding circle
    (seen from the sensor, with a degree to spare): the others cannot hit
    it, so tracing only these gives the same points in the same order."""
    dist = float(np.hypot(centre[0], centre[1]))
    if dist <= radius * 1.05:
        return np.ones(len(azimuth), bool)
    half = np.arcsin(radius / dist) + np.deg2rad(1.0)
    gap = np.abs((azimuth - np.arctan2(centre[0], centre[1]) + np.pi)
                 % (2 * np.pi) - np.pi)
    return gap <= half


def _car_parts(mesh_scale: float, rng: np.random.Generator):
    aspect = CAR_ASPECT * rng.uniform(0.88, 1.12, 3)
    w2, l2, h2 = aspect / aspect.max() * 0.5 * mesh_scale
    body = (np.zeros(3), np.array([w2, l2, h2 * 0.62]))
    cabin_len = l2 * rng.uniform(0.38, 0.52)
    cabin_shift = -l2 * rng.uniform(0.12, 0.3)
    cabin = (np.array([0.0, cabin_shift, h2 * 0.45]),
             np.array([w2 * 0.9, cabin_len, h2 * 0.55]))
    hood = (np.array([0.0, l2 * 0.8, -h2 * 0.25]),
            np.array([w2 * 0.95, l2 * 0.2, h2 * 0.35]))
    return [body, cabin, hood]


def scene(seed: int, vres: int, hres: int):
    """(cloud1, cloud2, labels) of one scene: float32 (n, 3) clouds and the
    labels as float64 (translation (3,), rel_angle, start_position (3,),
    end_position (3,), start_angle, end_angle)."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(-np.pi, np.pi)
    velocity = rng.uniform(0, 1)
    translation = np.array([np.sin(angle), np.cos(angle), 0.0]) * velocity
    rel_angle = rng.uniform(-np.pi, np.pi) / 2.0
    polar_angle = rng.uniform(-np.pi, np.pi)
    polar_distance = rng.uniform(4, 20)
    start_position = (np.array([np.sin(polar_angle), np.cos(polar_angle), 0.0])
                      * polar_distance)
    start_angle = rng.uniform(-np.pi, np.pi)
    end_position = start_position + translation
    end_angle = start_angle + rel_angle
    mesh_scale = rng.uniform(6, 6)
    mesh_id = int(rng.integers(1, 51))
    parts = _car_parts(mesh_scale, np.random.default_rng(mesh_id * 1009))
    all_dirs = lidar_rays(vres, hres)
    azimuth = np.arctan2(all_dirs[:, 0], all_dirs[:, 1])
    radius = max(np.linalg.norm(np.abs(off) + half) for off, half in parts)
    clouds = []
    for pose in (get_mat_angle(start_position, start_angle),
                 get_mat_angle(end_position, end_angle)):
        dirs = all_dirs[_may_hit(azimuth, pose[:3, 3], radius)]
        t, hit = _ray_parts_t(dirs, pose, parts)
        pts = dirs[hit] * t[hit, None]
        if len(pts):
            strength = max(0.005, 0.05 * float(np.linalg.norm(pose[:3, 3]))
                           / 80.0)
            pts = pts + np.clip(strength * rng.standard_normal(pts.shape),
                                -0.05, 0.05)
        clouds.append(np.asarray(pts, dtype=np.float32))
    labels = {"translation": translation, "rel_angle": float(rel_angle),
              "start_position": start_position, "end_position": end_position,
              "start_angle": float(start_angle), "end_angle": float(end_angle),
              "seed": int(seed), "mesh_id": mesh_id}
    return clouds[0], clouds[1], labels


def _scene_job(args):
    seed, vres, hres = args
    return scene(seed, vres, hres)


def scene_seeds(seed: int, stream: int):
    """The endless stream of scene seeds of (run seed, stream)."""
    base = (int(seed) * 8 + stream) * (1 << 20)
    i = 0
    while True:
        yield base + i
        i += 1


def make_scenes(seed: int, stream: int, count: int, vres: int, hres: int,
                workers: int):
    """``count`` scenes of the seed's stream whose clouds both have at least
    MIN_POINTS points, generated in ``workers`` processes (spawned, one BLAS
    thread each), in seed order."""
    import concurrent.futures
    import multiprocessing

    seeds = scene_seeds(seed, stream)
    out = []
    ctx = multiprocessing.get_context("spawn")
    env = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(dict.fromkeys(env, "1"))
    try:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as pool:
            while len(out) < count:
                want = count - len(out)
                batch = [(next(seeds), vres, hres)
                         for _ in range(want + want // 16 + 1)]
                for c1, c2, lab in pool.map(_scene_job, batch, chunksize=4):
                    if (min(len(c1), len(c2)) >= MIN_POINTS
                            and len(out) < count):
                        out.append((c1, c2, lab))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def write_dataset(basepath: str, scenes, num_train: int):
    """The scenes in the dataset layout (meta/, pointcloud1/, pointcloud2/,
    split/): file index i is scene i; the first ``num_train`` form the
    training split and the rest the val split."""
    for sub in ("meta", "pointcloud1", "pointcloud2", "split"):
        os.makedirs(os.path.join(basepath, sub), exist_ok=True)

    def text(a):
        import io
        buf = io.BytesIO()
        np.savetxt(buf, np.asarray(a))
        return buf.getvalue().decode("ascii")

    for i, (c1, c2, lab) in enumerate(scenes):
        name = str(i).zfill(8)
        np.save(os.path.join(basepath, "pointcloud1", name), c1)
        np.save(os.path.join(basepath, "pointcloud2", name), c2)
        meta = {"start_position": text(lab["start_position"]),
                "start_angle": lab["start_angle"],
                "end_position": text(lab["end_position"]),
                "end_angle": lab["end_angle"],
                "translation": text(lab["translation"]),
                "rel_angle": lab["rel_angle"],
                "version": GENERATOR_VERSION, "seed": lab["seed"],
                "mesh_id": lab["mesh_id"], "mesh_scale": 6.0, "cat": "car"}
        with open(os.path.join(basepath, "meta", name + ".json"), "w") as f:
            json.dump(meta, f)
    n = len(scenes)
    for split, idxs in (("train", range(num_train)),
                        ("val", range(num_train, n))):
        with open(os.path.join(basepath, "split", f"{split}.txt"), "w") as f:
            f.write("\n".join(str(i) for i in idxs) + "\n")
