"""Euler angle / rotation conversions (z-y-x intrinsic convention).

From-scratch equivalents of the reference's vendored eulerangles module
(reference utils/eulerangles.py:98-410): composition order
``M = Mz @ My @ Mx`` with z applied first to vectors on the right.

The port's own copy of ``alignnet3d_tpu/utils/euler.py``.
"""

from __future__ import annotations

import math

import numpy as np


def euler2mat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """Rotation matrix for z-y-x Euler angles: ``M = Mx @ My @ Mz`` —
    z rotation applied first to column vectors (reference
    eulerangles.py:98-195: ``reduce(dot, Ms[::-1])``)."""
    cz, sz = math.cos(z), math.sin(z)
    cy, sy = math.cos(y), math.sin(y)
    cx, sx = math.cos(x), math.sin(x)
    Mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    My = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Mx @ My @ Mz


def mat2euler(M, cy_thresh: float | None = None):
    """(z, y, x) angles of a rotation matrix (reference
    eulerangles.py:198-268)."""
    M = np.asarray(M)
    if cy_thresh is None:
        cy_thresh = np.finfo(M.dtype).eps * 4 if M.dtype.kind == "f" else 1e-6
    r11, r12, r13, r21, r22, r23, r31, r32, r33 = M.flat[:9]
    cy = math.sqrt(r33 * r33 + r23 * r23)
    if cy > cy_thresh:
        z = math.atan2(-r12, r11)
        y = math.atan2(r13, cy)
        x = math.atan2(-r23, r33)
    else:  # gimbal lock: cos(y) ~ 0
        z = math.atan2(r21, r22)
        y = math.atan2(r13, cy)
        x = 0.0
    return z, y, x


def euler2quat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """(w, x, y, z) quaternion for z-y-x Euler angles (reference
    eulerangles.py:271-316)."""
    z, y, x = z / 2.0, y / 2.0, x / 2.0
    cz, sz = math.cos(z), math.sin(z)
    cy, sy = math.cos(y), math.sin(y)
    cx, sx = math.cos(x), math.sin(x)
    return np.array([
        cx * cy * cz - sx * sy * sz,
        cy * cz * sx + cx * sy * sz,
        cx * cz * sy - cy * sx * sz,
        cx * cy * sz + cz * sx * sy,
    ])


def quat2mat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    return np.array([
        [1.0 - (yY + zZ), xY - wZ, xZ + wY],
        [xY + wZ, 1.0 - (xX + zZ), yZ - wX],
        [xZ - wY, yZ + wX, 1.0 - (xX + yY)],
    ])


def quat2euler(q):
    """(z, y, x) angles of a (w, x, y, z) quaternion (reference
    eulerangles.py:319-345)."""
    return mat2euler(quat2mat(q))


def euler2angle_axis(z: float = 0, y: float = 0, x: float = 0):
    """(theta, unit_vector) of the combined rotation (reference
    eulerangles.py:348-379)."""
    w, qx, qy, qz = euler2quat(z, y, x)
    vec = np.array([qx, qy, qz])
    n = np.linalg.norm(vec)
    theta = 2.0 * math.atan2(n, w)
    if n < 1e-12:
        return 0.0, np.array([1.0, 0, 0])
    return theta, vec / n


def angle_axis2euler(theta: float, vector, is_normalized: bool = False):
    """(z, y, x) of a rotation given as angle + axis (reference
    eulerangles.py:382-410)."""
    vector = np.asarray(vector, np.float64)
    if not is_normalized:
        vector = vector / np.linalg.norm(vector)
    half = theta / 2.0
    q = np.array([math.cos(half), *(math.sin(half) * vector)])
    return quat2euler(q)
