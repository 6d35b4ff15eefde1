"""Batched rigid yaw transforms of point clouds, in PyTorch.

Counterpart of ``alignnet3d_tpu/ops/transforms.py``; the reference rotates
per sample with ``tf.map_fn`` (models/tp8.py:125, 365).
"""

from __future__ import annotations

import torch


def rotation_matrix_z(angles: torch.Tensor) -> torch.Tensor:
    """(B,) yaw angles -> (B, 3, 3) rotation matrices about +z."""
    c, s = torch.cos(angles), torch.sin(angles)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zeros], dim=-1),
            torch.stack([s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def rotate_points_z(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (B, N, 3) points by per-sample yaw ``angles`` (B,).

    Computes ``points @ R`` (matrix on the RIGHT), as the reference's
    ``tf.matmul(pcs, rotation_mats)`` (tp8.py:127, 366): passing ``-a``
    rotates the points by ``+a`` in the usual convention.
    """
    return torch.einsum("bnd,bde->bne", points, rotation_matrix_z(angles))


def transform_pcs(pcs: torch.Tensor, translations: torch.Tensor | None = None,
                  angles: torch.Tensor | None = None,
                  rotation_centers: torch.Tensor | None = None) -> torch.Tensor:
    """Reference tf_transform_pcs (tp8.py:361-371) with its exact semantics:
    shift by ``-rotation_centers``, rotate by ``p @ Rz(angle)``, SUBTRACT
    ``translations``, shift back by ``+rotation_centers``."""
    if rotation_centers is not None:
        pcs = pcs - rotation_centers[:, None, :]
    if angles is not None:
        pcs = rotate_points_z(pcs, angles)
    if translations is not None:
        pcs = pcs - translations[:, None, :]
    if rotation_centers is not None:
        pcs = pcs + rotation_centers[:, None, :]
    return pcs


def apply_rigid(pcs: torch.Tensor, translations: torch.Tensor,
                angles: torch.Tensor,
                rotation_centers: torch.Tensor) -> torch.Tensor:
    """Forward rigid motion ``R(p - c) + c + t`` of (B, N, 3) ``pcs``, as
    ``geometry.get_mat_angle`` applied to points."""
    rot = rotation_matrix_z(angles)
    centered = pcs - rotation_centers[:, None, :]
    rotated = torch.einsum("bde,bne->bnd", rot, centered)
    return rotated + (rotation_centers + translations)[:, None, :]
