"""Yaw bin/residual codec, in PyTorch (batched) and numpy (eval decode).

Counterpart of ``alignnet3d_tpu/ops/angle_codec.py`` (reference
models/tp8.py:181-301). A yaw is a bin of width 2pi/num_bins, centred at
``k * 2pi/num_bins``, plus a residual. The angle heads emit ``num_bins``
class logits followed by ``num_bins`` normalised residuals.

``residual_scale`` keeps the reference's two decodes apart: ``pi/num_bins``
is the in-graph decode (tf_get_angles), ``1.0`` the eval-time decode that
uses the raw residual as radians (classLogits2angle).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def angle2class(angle: torch.Tensor, num_bins: int):
    """Continuous yaw -> (bin id int32, residual). Batched over leading dims."""
    angle = torch.remainder(angle, TWO_PI)
    angle_per_class = TWO_PI / num_bins
    shifted = torch.remainder(angle + angle_per_class / 2.0, TWO_PI)
    class_id = (shifted / angle_per_class).to(torch.int32)
    residual = shifted - (
        class_id.to(angle.dtype) * angle_per_class + angle_per_class / 2.0
    )
    return class_id, residual


def class2angle(class_id: torch.Tensor, residual: torch.Tensor, num_bins: int,
                to_label_format: bool = True) -> torch.Tensor:
    """(bin id, residual) -> yaw, wrapped to [-pi, pi) in label format."""
    angle = class_id.to(torch.float32) * (TWO_PI / num_bins) + residual
    if to_label_format:
        angle = torch.remainder(angle + np.pi, TWO_PI) - np.pi
    return angle


def logits_to_angle(logits: torch.Tensor, num_bins: int,
                    residual_scale: float) -> torch.Tensor:
    """Decode ``[..., 2*num_bins]`` head output to yaw: the argmax bin (the
    first on ties) plus that bin's residual times ``residual_scale``."""
    classes = torch.argmax(logits[..., :num_bins], dim=-1)
    residuals = logits[..., num_bins:] * residual_scale
    per_class = torch.gather(residuals, -1, classes[..., None])[..., 0]
    return class2angle(classes, per_class, num_bins)


def class_logits_to_angle_np(logits: np.ndarray, num_bins: int,
                             residual_scale: float = 1.0) -> np.ndarray:
    """Numpy eval-path decoder (reference classLogits2angle,
    tp8.py:241-244). The default ``residual_scale=1.0`` keeps the
    reference's unscaled-residual quirk."""
    logits = np.asarray(logits)
    class_logits = logits[..., :num_bins]
    residuals = logits[..., num_bins:] * residual_scale
    classes = np.argmax(class_logits, axis=-1)
    per_class_residual = np.take_along_axis(
        residuals, classes[..., None], axis=-1
    )[..., 0]
    angle = classes * (TWO_PI / num_bins) + per_class_residual
    # the reference subtracts 2pi only when angle > pi (tp8.py:236-237)
    return np.where(angle > np.pi, angle - TWO_PI, angle)


def soft_angle_targets(target_angles_deg: torch.Tensor, num_bins: int,
                       sigma_in_degree: float) -> torch.Tensor:
    """Soft per-bin target distribution (B, num_bins) from three Normal
    CDFs at {t - 360, t, t + 360} degrees, differenced over the bin edges
    (reference tf_get_target_angle_distribution, tp8.py:253-263). The
    targets are in DEGREES."""
    t = target_angles_deg[:, None, None]
    locs = t + torch.tensor([-360.0, 0.0, 360.0], dtype=t.dtype,
                            device=t.device)[None, None, :]
    edges = (torch.arange(num_bins + 1, dtype=torch.float32, device=t.device)
             * (360.0 / num_bins))[None, :, None]
    z = (edges - locs) / (sigma_in_degree * np.sqrt(2.0))
    cdf = 0.5 * (1.0 + torch.erf(z))
    probs = torch.sum(torch.roll(cdf, -1, dims=1) - cdf, dim=2)
    return probs[:, :-1]


def jax_angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference b - a wrapped to (-pi, pi] (reference
    tf_get_angle_difference, tp8.py:161-164); the JAX package's name."""
    r = torch.remainder(b - a, TWO_PI)
    return torch.where(r > np.pi, r - TWO_PI, r)
