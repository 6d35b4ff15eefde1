"""Point-cloud utility ports: volume conversion and lightweight image
rendering (reference utils/pc_util.py:24-180), vectorized.

The port's own copy of ``alignnet3d_tpu/utils/pc_util.py``, over the port's
``utils/euler.py`` and ``utils/ply.py``.
"""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.utils.euler import euler2mat
from alignnet3d_tpu_torch.utils.ply import read_ply_xyz, write_ply  # noqa: F401


def point_cloud_to_volume(points: np.ndarray, vsize: int,
                          radius: float = 1.0) -> np.ndarray:
    """Occupancy volume of a cloud assumed inside an origin-centered cube of
    half-size ``radius`` (reference pc_util.py:41-53), vectorized."""
    vol = np.zeros((vsize, vsize, vsize), dtype=bool)
    voxel = 2 * radius / float(vsize)
    loc = ((np.asarray(points) + radius) / voxel).astype(int)
    loc = np.clip(loc, 0, vsize - 1)
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = True
    return vol.astype(np.float32)


def point_cloud_to_volume_batch(point_clouds, vsize: int = 12,
                                radius: float = 1.0, flatten: bool = True):
    """(reference pc_util.py:24-38)."""
    vols = [point_cloud_to_volume(np.squeeze(pc), vsize, radius)
            for pc in point_clouds]
    if flatten:
        return np.vstack([v.flatten()[None] for v in vols])
    return np.stack([v[..., None] for v in vols])


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupied voxel indices as (N, 3) points (reference pc_util.py:56-71)."""
    return np.argwhere(np.asarray(vol) > 0).astype(np.float64)


def draw_point_cloud(input_points: np.ndarray, canvasSize: int = 500,
                     space: int = 200, diameter: int = 25,
                     xrot: float = 0, yrot: float = 0, zrot: float = 0,
                     switch_xyz=(0, 1, 2), normalize: bool = True) -> np.ndarray:
    """Render points to a grayscale orthographic image with gaussian disk
    splats (reference pc_util.py:97-153), vectorized over points."""
    image = np.zeros((canvasSize, canvasSize))
    if input_points is None or input_points.shape[0] == 0:
        return image
    points = np.asarray(input_points)[:, list(switch_xyz)]
    M = euler2mat(zrot, yrot, xrot)
    points = points @ M.T

    if normalize:
        centroid = np.mean(points, axis=0)
        points = points - centroid
        furthest = np.max(np.sqrt(np.sum(points ** 2, axis=-1)))
        if furthest > 0:
            points = points / furthest

    # gaussian disk stamp
    radius = diameter // 2
    xx, yy = np.meshgrid(np.arange(diameter) - radius,
                         np.arange(diameter) - radius)
    disk_mask = (xx ** 2 + yy ** 2) <= radius ** 2
    disk = np.exp(-(xx ** 2 + yy ** 2) / (radius ** 2 * 0.5)) * disk_mask
    dx, dy = np.nonzero(disk_mask)
    dv = disk[dx, dy]
    dx, dy = dx - radius, dy - radius

    # paint back-to-front (sort by depth like the reference zorder sort)
    order = np.argsort(points[:, 0])
    points = points[order]
    px = ((points[:, 0] + 1) / 2 * space).astype(int) + \
        (canvasSize - space) // 2
    py = ((points[:, 1] + 1) / 2 * space).astype(int) + \
        (canvasSize - space) // 2
    depth_weight = points[:, 2] if len(points) else np.zeros(0)
    dmin = depth_weight.min() if len(depth_weight) else 0.0
    weights = depth_weight - dmin + 0.5

    all_x = (px[:, None] + dx[None, :]).ravel()
    all_y = (py[:, None] + dy[None, :]).ravel()
    all_v = (weights[:, None] * dv[None, :]).ravel()
    valid = (all_x >= 0) & (all_x < canvasSize) & (all_y >= 0) & \
        (all_y < canvasSize)
    np.maximum.at(image, (all_x[valid], all_y[valid]), all_v[valid])

    if image.max() > 0:
        image = image / image.max()
    return image


def point_cloud_three_views(points: np.ndarray) -> np.ndarray:
    """Three orthogonal renders concatenated horizontally
    (reference pc_util.py:156-168)."""
    img1 = draw_point_cloud(
        points, zrot=110 / 180.0 * np.pi, xrot=45 / 180.0 * np.pi, yrot=0
    )
    img2 = draw_point_cloud(
        points, zrot=70 / 180.0 * np.pi, xrot=135 / 180.0 * np.pi, yrot=0
    )
    img3 = draw_point_cloud(
        points, zrot=180.0 / 180.0 * np.pi, xrot=90 / 180.0 * np.pi, yrot=0
    )
    return np.concatenate([img1, img2, img3], axis=1)
