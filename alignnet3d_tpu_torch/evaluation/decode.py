"""Network output -> relative pose, shared by every consumer of the forward.

Counterpart of ``alignnet3d_tpu/evaluation/decode.py`` (reference
train.py:289-312): per-view class+residual yaws composed as
``a2 - a1 + ar``, translations taken directly, and the optional flip
resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from alignnet3d_tpu_torch.ops.angle_codec import class_logits_to_angle_np


class DecodedPose(NamedTuple):
    translations: np.ndarray  # (n, 3)
    angles: np.ndarray        # (n,) composed yaw a2 - a1 + ar
    s2_pc1centers: np.ndarray  # (n, 3)
    ang1: np.ndarray          # (n,) per-view decoded yaws
    ang2: np.ndarray


def decode_pair_outputs(out, pc1, pc2, num_bins: int, residual_scale: float,
                        resolve_flips: bool, n: int | None = None, *,
                        device: torch.device | str) -> DecodedPose:
    """Decode a forward output dict (host numpy arrays) into relative-pose
    arrays. ``pc1``/``pc2`` are the input clouds that produced ``out``: the
    flip resolver, which runs on ``device``, scores against them. ``n``
    trims padding rows."""
    if n is None:
        n = len(out["pred_translations"])
    ang1 = class_logits_to_angle_np(
        out["pred_pc1angle_logits"][:n], num_bins, residual_scale)
    ang2 = class_logits_to_angle_np(
        out["pred_pc2angle_logits"][:n], num_bins, residual_scale)
    angr = class_logits_to_angle_np(
        out["pred_remaining_angle_logits"][:n], num_bins, residual_scale)
    composed = ang2 - ang1 + angr
    translations = np.asarray(out["pred_translations"][:n])
    centers = np.asarray(out["pred_s2_pc1centers"][:n])
    if resolve_flips:
        from alignnet3d_tpu_torch.ops.flip_resolve import apply_flip_resolution

        composed, _ = apply_flip_resolution(
            np.asarray(pc1[:n]), np.asarray(pc2[:n]),
            translations, composed, centers, device=device,
        )
    return DecodedPose(translations, composed, centers, ang1, ang2)
