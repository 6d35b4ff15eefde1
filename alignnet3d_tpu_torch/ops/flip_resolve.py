"""Inference-time 180-degree flip resolution.

Counterpart of ``alignnet3d_tpu/ops/flip_resolve.py``. Models trained with
``accept_inverted_angle`` know the yaw only mod pi. Both hypotheses are
applied to cloud1, and the one whose one-sided chamfer distance to cloud2
is smaller wins. The nearest-neighbour search is ``nn_argmin``: the CUDA
kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from alignnet3d_tpu_torch import tracing
from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin
from alignnet3d_tpu_torch.ops.transforms import apply_rigid


def _one_sided_chamfer(moved: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over points of the nearest-neighbour distance, (B,)."""
    mask = torch.ones(target.shape[:2], dtype=torch.bool, device=target.device)
    _, d2 = nn_argmin(moved.contiguous(), target.contiguous(), mask)
    return torch.mean(torch.sqrt(d2), dim=1)


def resolve_flips(pcs1: torch.Tensor, pcs2: torch.Tensor,
                  translations: torch.Tensor, angles: torch.Tensor,
                  centers: torch.Tensor):
    """Pick theta vs theta+pi per pair. pcs (B, N, 3); translations and
    centers (B, 3); angles (B,). Returns (B,) bool, True where theta+pi
    aligns better, and the two chamfer scores."""
    moved = apply_rigid(pcs1, translations, angles, centers)
    moved_flip = apply_rigid(pcs1, translations, angles + np.pi, centers)
    d = _one_sided_chamfer(moved, pcs2)
    d_flip = _one_sided_chamfer(moved_flip, pcs2)
    return d_flip < d, d, d_flip


def apply_flip_resolution(pcs1, pcs2, translations, angles, centers, *,
                          device: torch.device | str):
    """Numpy in, numpy out: returns the corrected angles (float64, wrapped
    to [-pi, pi)) and the per-pair flip decisions."""
    def dev(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                               device=device)

    with tracing.span("flips.resolve"):
        flip, _, _ = resolve_flips(
            dev(pcs1, np.shape(pcs1)), dev(pcs2, np.shape(pcs2)),
            dev(translations, (-1, 3)), dev(angles, (-1,)),
            dev(centers, (-1, 3)),
        )
        flip = flip.cpu().numpy()
        out = np.asarray(angles, np.float64).reshape(-1).copy()
        out = np.where(flip, out + np.pi, out)
        out = (out + np.pi) % (2 * np.pi) - np.pi
        return out, flip
