"""KITTI tracking toolbox: calibration, label parsing, object extraction,
relative-transform derivation, and the dataset writer.

The port's own copy of ``alignnet3d_tpu/data/kitti.py`` (numpy only, the
same arithmetic), with the behaviour of the reference's dataset-generation
pipeline (reference tp_utils/pointcloud.py: Calibration :41-223,
KittiTrackingLabels :597-738, velo loading with visual-odometry
compensation :750-765, frustum/3D-box extraction :769-801,
pose/relative-transform derivation :876-906, FromKITTIScene :1000-1033).

Coordinate conventions (KITTI paper):
- velodyne: x forward, y left, z up
- rect camera: x right, y down, z forward
- "global" frame used by the datasets: the nominal axis permutation
  ``R_KITTI2GLOBAL`` applied to rect coordinates (the reference's
  R1 @ R2 product); box positions/angles in the meta JSONs live there.

Note (kept from the reference): the 3D-box point extraction uses the
NOMINAL axis swap between velodyne and camera coordinates, not the
per-sequence calibration (pointcloud.py:844-863); the full
``Calibration`` class serves the image-FOV / 2D-box path where the
reference does use it.
"""

from __future__ import annotations

import os

import numpy as np

from alignnet3d_tpu_torch.geometry import get_mat_angle, np_to_str

# nominal rect-cam -> global axis permutation (reference R1 @ R2,
# pointcloud.py:844-846): row-vector convention, applied as  v @ R.
R_KITTI2GLOBAL = np.array([
    [0.0, -1.0, 0.0],
    [0.0, 0.0, -1.0],
    [1.0, 0.0, 0.0],
])

TRACKING_COLUMNS = (
    "id class truncated occluded alpha x1 y1 x2 y2 xd yd zd x y z roty"
).split()
TRACKING_CLASSES = (
    "Car Van Truck Pedestrian Person_sitting Cyclist Tram Misc DontCare"
).split()


def inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t]."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class Calibration:
    """KITTI calibration with precomposed projection matrices.

    Unlike the reference (which chains per-call matmuls,
    pointcloud.py:157-202), the velo->rect and rect->image transforms are
    composed once at load time.
    """

    def __init__(self, calib_filepath: str | None = None, calibs=None):
        if calibs is None:
            calibs = self.read_calib_file(calib_filepath)
        self.P = np.reshape(calibs["P2"], (3, 4))
        self.V2C = np.reshape(calibs["Tr_velo_to_cam"], (3, 4))
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = np.reshape(calibs["R0_rect"], (3, 3))

        self.c_u, self.c_v = self.P[0, 2], self.P[1, 2]
        self.f_u, self.f_v = self.P[0, 0], self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

        # precomposed velo -> rect: R0 @ [V2C]
        self._velo2rect = np.eye(4)
        self._velo2rect[:3, :] = self.R0 @ self.V2C
        self._rect2velo = np.linalg.inv(self._velo2rect)

    @classmethod
    def from_video_dir(cls, calib_root_dir: str) -> "Calibration":
        """Build from raw-KITTI video calib files (calib_cam_to_cam.txt +
        calib_velo_to_cam.txt), reference pointcloud.py:131-144."""
        cam2cam = cls.read_calib_file(
            os.path.join(calib_root_dir, "calib_cam_to_cam.txt")
        )
        velo2cam = cls.read_calib_file(
            os.path.join(calib_root_dir, "calib_velo_to_cam.txt")
        )
        tr = np.zeros((3, 4))
        tr[:3, :3] = np.reshape(velo2cam["R"], (3, 3))
        tr[:, 3] = velo2cam["T"]
        return cls(calibs={
            "Tr_velo_to_cam": tr.reshape(12),
            "R0_rect": cam2cam["R_rect_00"],
            "P2": cam2cam["P_rect_02"],
        })

    @staticmethod
    def read_calib_file(filepath: str) -> dict:
        data = {}
        with open(filepath) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                key, value = line.split(" ", 1)
                key = key.replace(":", "")
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        # tracking-split key aliases (reference pointcloud.py:119-121)
        if "Tr_velo_cam" in data and "Tr_velo_to_cam" not in data:
            data["Tr_velo_to_cam"] = data["Tr_velo_cam"]
        if "R_rect" in data and "R0_rect" not in data:
            data["R0_rect"] = data["R_rect"]
        return data

    # 3d <-> 3d
    def project_velo_to_rect(self, pts):
        pts = np.asarray(pts, np.float64)
        return pts @ self._velo2rect[:3, :3].T + self._velo2rect[:3, 3]

    def project_rect_to_velo(self, pts):
        pts = np.asarray(pts, np.float64)
        return pts @ self._rect2velo[:3, :3].T + self._rect2velo[:3, 3]

    # 3d -> 2d
    def project_rect_to_image(self, pts):
        pts = np.asarray(pts, np.float64)
        uvw = pts @ self.P[:, :3].T + self.P[:, 3]
        return uvw[:, :2] / uvw[:, 2:3]

    def project_velo_to_image(self, pts):
        return self.project_rect_to_image(self.project_velo_to_rect(pts))

    # 2d -> 3d
    def project_image_to_rect(self, uv_depth):
        uv_depth = np.asarray(uv_depth, np.float64)
        z = uv_depth[:, 2]
        x = (uv_depth[:, 0] - self.c_u) * z / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * z / self.f_v + self.b_y
        return np.stack([x, y, z], axis=1)

    def project_image_to_velo(self, uv_depth):
        return self.project_rect_to_velo(self.project_image_to_rect(uv_depth))


class TrackingLabels:
    """KITTI tracking label parser: DontCare removal, occlusion/truncation
    windows, 0-based contiguous track ids, and track re-splitting when an
    object reappears after absence (reference KittiTrackingLabels,
    pointcloud.py:597-738) — implemented on plain numpy record rows."""

    def __init__(self, path: str, remove_dontcare: bool = True,
                 truncated_threshold=2.0, occluded_threshold=3.0,
                 split_on_reappear: bool = True):
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < len(TRACKING_COLUMNS) + 1:
                    continue
                frame = int(parts[0])
                rec = dict(zip(TRACKING_COLUMNS, parts[1:]))
                rec["frame"] = frame
                rows.append(rec)
        for rec in rows:
            for k in TRACKING_COLUMNS:
                if k != "class":
                    rec[k] = float(rec[k])
            rec["id"] = int(rec["id"])

        if remove_dontcare:
            rows = [r for r in rows if r["class"] != "DontCare"]

        occ = occluded_threshold if isinstance(occluded_threshold, (tuple, list)) \
            else (0, occluded_threshold)
        trunc = truncated_threshold if isinstance(truncated_threshold, (tuple, list)) \
            else (0, truncated_threshold)
        rows = [
            r for r in rows
            if occ[0] <= r["occluded"] <= occ[1]
            and trunc[0] <= r["truncated"] <= trunc[1]
        ]

        # 0-based contiguous ids in order of first appearance
        id_map = {}
        for r in rows:
            if r["id"] not in id_map:
                id_map[r["id"]] = len(id_map)
        for r in rows:
            r["id"] = id_map[r["id"]]

        if split_on_reappear and rows:
            next_id = max(r["id"] for r in rows) + 1
            by_id: dict[int, list] = {}
            for r in rows:
                by_id.setdefault(r["id"], []).append(r)
            for tid in sorted(by_id):
                recs = sorted(by_id[tid], key=lambda r: r["frame"])
                current = tid
                for prev, cur in zip(recs, recs[1:]):
                    if cur["frame"] - prev["frame"] > 1:
                        current = next_id
                        next_id += 1
                    if current != tid:
                        cur["id"] = current

        self.rows = rows
        self.ids = sorted({r["id"] for r in rows})

    def tracklets(self):
        """Rows as the reference's 17-column tracklet vectors:
        [seq(frame-placeholder), frame, id, class, truncated, occluded,
         x y z h w l roty(?), x1 y1 x2 y2] layout used downstream.

        We expose dicts instead — callers access fields by name; the
        ``boxvec`` property packs [x, y, z, h, w, l, roty] for the
        geometry helpers.
        """
        return self.rows

    def by_frame(self):
        out: dict[int, list] = {}
        for r in self.rows:
            out.setdefault(r["frame"], []).append(r)
        return out

    @staticmethod
    def boxvec(row) -> np.ndarray:
        # rect-camera box: center x,y,z (y at box bottom), h,w,l, yaw
        return np.array([
            row["x"], row["y"], row["z"],
            row["xd"], row["yd"], row["zd"], row["roty"],
        ])


def load_velo_scan(filename: str) -> np.ndarray:
    """(N, 4) float32 velodyne scan (reference pointcloud.py:741-744)."""
    return np.fromfile(filename, dtype=np.float32).reshape(-1, 4)


def apply_visual_odometry(points: np.ndarray, vo_mat: np.ndarray) -> np.ndarray:
    """Ego-motion-compensate a scan with a visual-odometry 4x4 given in the
    global frame (reference pointcloud.py:754-763)."""
    R4 = np.eye(4)
    R4[:3, :3] = R_KITTI2GLOBAL
    vo = R4.T @ vo_mat @ R4
    hom = np.concatenate([points[:, :3], np.ones((len(points), 1))], axis=1)
    out = hom @ vo.T
    return out[:, :3] / out[:, 3:4]


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def compute_box_3d(boxvec: np.ndarray) -> np.ndarray:
    """(8, 3) rect-camera corners of [x,y,z,h,w,l,ry] (reference
    pointcloud.py:918-940; y is the box BOTTOM, KITTI convention)."""
    R = roty(boxvec[6])
    h, w, l = boxvec[3:6]
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    corners = R @ np.vstack([x_c, y_c, z_c])
    return (corners + np.asarray(boxvec[:3])[:, None]).T


def points_in_box_3d(points: np.ndarray, boxvec: np.ndarray) -> np.ndarray:
    """Boolean mask of rect-camera points inside the oriented box.

    Direct OBB containment test (transform into the box frame and compare
    against half extents) — equivalent to but faster than the reference's
    Delaunay-hull test over the 8 corners (pointcloud.py:769-778)."""
    R = roty(boxvec[6])
    h, w, l = boxvec[3:6]
    center = np.asarray(boxvec[:3], np.float64) + R @ np.array([0, -h / 2, 0])
    local = (np.asarray(points, np.float64) - center) @ R  # R^-1 = R^T; vR = R^T v
    half = np.array([l / 2, h / 2, w / 2])
    return np.all(np.abs(local) <= half + 1e-9, axis=1)


def extract_object_points(scan_velo: np.ndarray, boxvec: np.ndarray) -> np.ndarray:
    """Points of one labeled object, in the global frame.

    Mirrors reference extract_pointcloud (pointcloud.py:853-863): nominal
    velo->cam axis swap, rect-frame box test, then map the object points
    into the global frame.
    """
    # nominal velo->rect is `@ R.T`; the extracted points then go
    # rect->global via `@ R` (reference pointcloud.py:859-863, 882)
    pts_cam = scan_velo[:, :3] @ R_KITTI2GLOBAL.T
    mask = points_in_box_3d(pts_cam, boxvec)
    return pts_cam[mask] @ R_KITTI2GLOBAL


def points_in_image_fov(pc_velo: np.ndarray, calib: Calibration, xmin, ymin,
                        xmax, ymax, clip_distance: float = 2.0):
    """Image-FOV filter (reference get_lidar_in_image_fov,
    pointcloud.py:781-791)."""
    pts_2d = calib.project_velo_to_image(pc_velo[:, :3])
    fov = (
        (pts_2d[:, 0] < xmax) & (pts_2d[:, 0] >= xmin)
        & (pts_2d[:, 1] < ymax) & (pts_2d[:, 1] >= ymin)
        & (pc_velo[:, 0] > clip_distance)
    )
    return pc_velo[fov], pts_2d, fov


def extract_points_in_box2d(pc_velo, box2d, calib, img_width, img_height):
    """2D-bbox frustum extraction (reference extract_pc_in_box2d,
    pointcloud.py:794-801)."""
    _, pts_2d, fov = points_in_image_fov(
        pc_velo, calib, 0, 0, img_width, img_height
    )
    xmin, ymin, xmax, ymax = box2d
    inside = (
        (pts_2d[:, 0] < xmax) & (pts_2d[:, 0] >= xmin)
        & (pts_2d[:, 1] < ymax) & (pts_2d[:, 1] >= ymin) & fov
    )
    return pc_velo[inside]


def extract_colors_for_points(points_global: np.ndarray, calib: Calibration,
                              image: np.ndarray) -> np.ndarray:
    """Per-point RGB sampled from the camera image (reference
    extract_color_from_pc, pointcloud.py:827-837), vectorized. Points are
    in the global frame; ``image`` is an (H, W, 3) array."""
    pts_rect = np.asarray(points_global, np.float64) @ R_KITTI2GLOBAL.T
    uv = calib.project_rect_to_image(pts_rect)
    uvi = uv.astype(np.int64)
    h, w = image.shape[:2]
    ok = (
        (uvi[:, 0] >= 0) & (uvi[:, 0] < w)
        & (uvi[:, 1] >= 0) & (uvi[:, 1] < h)
        & (pts_rect[:, 2] > 0)
    )
    colors = np.zeros((len(points_global), 3), np.float64)
    colors[ok] = np.asarray(image, np.float64)[uvi[ok, 1], uvi[ok, 0]]
    return colors


def get_transform_components(boxvec: np.ndarray):
    """Object pose (global-frame position with z at box center, yaw)
    (reference pointcloud.py:876-885)."""
    position = np.asarray(boxvec[:3], np.float64) @ R_KITTI2GLOBAL
    angle = float(boxvec[6])
    h = boxvec[3]
    position = position.copy()
    position[2] += h / 2.0
    return position, angle


def get_relative_transform(boxvec1: np.ndarray, boxvec2: np.ndarray):
    """Relative motion between two box observations, ground-plane
    constrained: z-translation is zeroed and returned separately
    (reference pointcloud.py:888-906)."""
    translation = np.asarray(boxvec2[:3], np.float64) - np.asarray(
        boxvec1[:3], np.float64
    )
    angle = float(boxvec2[6] - boxvec1[6])
    rotation_center = np.asarray(boxvec1[:3], np.float64) @ R_KITTI2GLOBAL
    translation = translation @ R_KITTI2GLOBAL
    z_difference = translation[2]
    translation = translation.copy()
    translation[2] = 0.0
    mat = get_mat_angle(translation, angle, rotation_center)
    return mat, translation, angle, rotation_center, z_difference


class FromKITTIScene:
    """One dataset sample from two tracklet observations (reference
    FromKITTIScene, pointcloud.py:1000-1033). The caller provides the two
    extracted object clouds (``extract_object_points``); this class derives
    the pose labels and writes the meta/cloud files."""

    def __init__(self, row1: dict, row2: dict, pc1: np.ndarray,
                 pc2: np.ndarray, seq: int):
        assert row1["id"] == row2["id"], "same track required"
        assert row1["class"] == row2["class"]
        box1 = TrackingLabels.boxvec(row1)
        box2 = TrackingLabels.boxvec(row2)
        (rel_mat, translation, angle, rotation_center,
         z_difference) = get_relative_transform(box1, box2)
        pc2 = pc2.copy()
        pc2[:, 2] -= z_difference  # reference pointcloud.py:1010
        self.pointclouds = [pc1, pc2]

        c1, a1 = get_transform_components(box1)
        c2, a2 = get_transform_components(box2)
        self.meta = {
            "start_position": np_to_str(c1),
            "start_angle": float(a1),
            "end_position": np_to_str(c2),
            "end_angle": float(a2),
            "translation": np_to_str(translation),
            "rel_angle": float(angle),
            "class": row1["class"],
            "truncated": row1["truncated"],
            "occluded": row1["occluded"],
            "seq": seq,
            "frames": [int(row1["frame"]), int(row2["frame"])],
            "trackids": [int(row1["id"]), int(row2["id"])],
        }

    def save(self, basepath: str, scene_idx: int):
        import json

        for sub in ("meta", "pointcloud1", "pointcloud2"):
            os.makedirs(os.path.join(basepath, sub), exist_ok=True)
        for k, pc in enumerate(self.pointclouds):
            np.save(
                f"{basepath}/pointcloud{k + 1}/{str(scene_idx).zfill(8)}",
                np.asarray(pc, np.float32),
            )
        with open(f"{basepath}/meta/{str(scene_idx).zfill(8)}.json", "w") as f:
            json.dump(self.meta, f)
