"""Rigid-motion math in numpy: yaw-only poses about an explicit centre.

The port's own copy of the functions it uses from
``alignnet3d_tpu/geometry.py`` (the port imports nothing of the JAX
package), with the same float64 arithmetic in the same order, so both
packages give bit-equal transforms. Semantics follow the reference's
geometry toolbox (reference tp_utils/pointcloud.py:279-289).
"""

from __future__ import annotations

import base64
import io

import numpy as np


def np_to_str(arr: np.ndarray, plaintext: bool = True) -> str:
    """An array in the ASCII codec of the dataset meta JSON files
    (reference pointcloud.py:247-257)."""
    output = io.BytesIO()
    if plaintext:
        np.savetxt(output, np.asarray(arr))
        return output.getvalue().decode("ascii")
    np.savez_compressed(output, arr=np.asarray(arr))
    return base64.b64encode(output.getvalue()).decode("ascii")


def str_to_np(s: str, plaintext: bool = True) -> np.ndarray:
    """Inverse of :func:`np_to_str` (reference pointcloud.py:260-265)."""
    if plaintext:
        return np.loadtxt(io.BytesIO(s.encode("ascii")))
    raw = base64.b64decode(s)
    return np.load(io.BytesIO(raw))["arr"]


def rotation_matrix_z(angle) -> np.ndarray:
    """3x3 rotation(s) about +z: input shape ``S`` -> ``S + (3, 3)``."""
    a = np.asarray(angle, dtype=np.float64)
    c, s = np.cos(a), np.sin(a)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    return np.stack(
        [
            np.stack([c, -s, zeros], axis=-1),
            np.stack([s, c, zeros], axis=-1),
            np.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )


def get_mat_angle(
    translation=None, rotation=None, rotation_center=np.array([0.0, 0.0, 0.0])
) -> np.ndarray:
    """4x4 transform: rotate by ``rotation`` (yaw) about ``rotation_center``,
    then translate: ``M = T(center + translation) @ Rz(rotation) @
    T(-center)`` (reference pointcloud.py:279-289)."""
    center = np.asarray(rotation_center, dtype=np.float64).reshape(3)
    mat = np.eye(4)
    if rotation is not None:
        mat[:3, :3] = rotation_matrix_z(float(np.asarray(rotation).reshape(-1)[0]))
    mat[:3, 3] = center - mat[:3, :3] @ center
    if translation is not None:
        mat[:3, 3] += np.asarray(translation, dtype=np.float64).reshape(3)
    return mat


def transform_points(points: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to an (N, 3) array of points."""
    pts = np.asarray(points, dtype=np.float64)
    return pts @ mat[:3, :3].T + mat[:3, 3]


def get_mat_angle_batch(translation, rotation, rotation_center) -> np.ndarray:
    """Vectorised :func:`get_mat_angle`: (n,3), (n,), (n,3) -> (n,4,4)."""
    t = np.asarray(translation, dtype=np.float64).reshape(-1, 3)
    a = np.asarray(rotation, dtype=np.float64).reshape(-1)
    c = np.asarray(rotation_center, dtype=np.float64).reshape(-1, 3)
    n = len(a)
    ca, sa = np.cos(a), np.sin(a)
    M = np.tile(np.eye(4), (n, 1, 1))
    M[:, 0, 0] = ca
    M[:, 0, 1] = -sa
    M[:, 1, 0] = sa
    M[:, 1, 1] = ca
    M[:, :3, 3] = c - np.einsum("nij,nj->ni", M[:, :3, :3], c) + t
    return M


def invert_rigid_batch(M: np.ndarray) -> np.ndarray:
    """Inverse of a batch of rigid 4x4 transforms: [[R.T, -R.T t], [0, 1]]."""
    R = M[..., :3, :3]
    out = np.tile(np.eye(4), M.shape[:-2] + (1, 1))
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, M[..., :3, 3])
    return out


def compose_gated_refinement(M1, t2, a2, c2, gate_deg: float,
                             gate_xy: float):
    """Compose a refinement pass's raw predictions (t2, a2, c2) onto the
    coarse transforms M1 (n,4,4), accepted per pair only inside the trust
    region |da| <= gate_deg (nearest mod-pi branch) and |dxy| <= gate_xy.
    Returns (M (n,4,4), accepted (n,) bool)."""
    a2 = np.asarray(a2, np.float64).reshape(-1)
    t2 = np.asarray(t2, np.float64).reshape(-1, 3)
    dM = get_mat_angle_batch(t2, a2, c2)
    M = np.einsum("nij,njk->nik", dM, M1)
    da = (a2 + np.pi / 2) % np.pi - np.pi / 2
    ok = (np.abs(np.degrees(da)) <= gate_deg) & (
        np.linalg.norm(t2[:, :2], axis=1) <= gate_xy
    )
    return np.where(ok[:, None, None], M, M1), ok


def wrap_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return (np.asarray(a) + np.pi) % (2.0 * np.pi) - np.pi


def translate_transform_to_new_center_of_rotation(
    all_pred_translations, all_pred_angles, all_pred_centers,
    all_gt_pc1centers,
) -> np.ndarray:
    """Predicted translations re-expressed for a rotation about the GT
    centre instead of the predicted one, ``t' = -(c_new - c_old) +
    Rz(a) (c_new - c_old) + t`` (reference pointcloud.py:309-318),
    vectorised."""
    t = np.asarray(all_pred_translations, dtype=np.float64).reshape(-1, 3)
    a = np.asarray(all_pred_angles, dtype=np.float64).reshape(-1)
    shift = (
        np.asarray(all_gt_pc1centers, dtype=np.float64).reshape(-1, 3)
        - np.asarray(all_pred_centers, dtype=np.float64).reshape(-1, 3)
    )
    rotated_shift = np.einsum("bij,bj->bi", rotation_matrix_z(a), shift)
    return (-shift + rotated_shift + t).astype(t.dtype)


def angle_diff(a, b):
    """Signed smallest difference ``a - b`` wrapped to (-pi, pi]
    (reference pointcloud.py:442-444)."""
    return wrap_angle(np.asarray(a) - np.asarray(b))


def heuristic_use_smaller_angle(pred_angles: np.ndarray) -> np.ndarray:
    """Map any angle in the 'large' half-circle to its 180-degree complement
    (reference pointcloud.py:301-306). Used for symmetric-object outputs."""
    a = np.mod(np.asarray(pred_angles, dtype=np.float64), 2.0 * np.pi)
    large = np.logical_and(a > 0.5 * np.pi, a < 1.5 * np.pi)
    a = np.where(large, np.mod(a + np.pi, 2.0 * np.pi), a)
    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


def constrain_transform(transform: np.ndarray) -> np.ndarray:
    """Project a 4x4 rigid transform onto ground-plane motion: keep the
    translation, replace the rotation by its best yaw-only approximation.

    Semantics of the reference's Python port of CloudCompare's
    FilterTransformation (pointcloud.py:1208-1254) with
    ``constrain_rotation='xy'`` — the same constraint the forked Open3D
    applies on the C++ side via ``with_constraint`` (icp.py:76).
    """
    new_transform = np.eye(4)
    new_transform[:3, 3] = transform[:3, 3]
    R = transform[:3, :3]
    if R[2, 0] < 1.0:
        theta = -np.arcsin(R[2, 0])
        cos_theta = np.cos(theta)
        phi = np.arctan2(R[1, 0] / cos_theta, R[0, 0] / cos_theta)
        new_transform[0, 0] = np.cos(phi)
        new_transform[1, 1] = np.cos(phi)
        new_transform[1, 0] = np.sin(phi)
        new_transform[0, 1] = -np.sin(phi)
    return new_transform


def decompose_yaw(transform: np.ndarray) -> tuple[np.ndarray, float]:
    """Extract (translation, yaw) from a (possibly yaw-only) 4x4 transform.

    Equivalent of the reference's ``Rotation.from_dcm(R).as_euler('xyz')[2]``
    extraction (train.py:476-482) for ground-plane transforms.
    """
    yaw = float(np.arctan2(transform[1, 0], transform[0, 0]))
    return np.asarray(transform[:3, 3], dtype=np.float64), yaw
