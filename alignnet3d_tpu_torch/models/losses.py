"""Training losses: the multi-stage 'separate' loss and the dense 'p2p'
loss (reference models/tp8.py:304-407).

Counterpart of ``alignnet3d_tpu/models/losses.py``: pure functions of
(end_points, labels), float32, batched, with the same ``aux`` tags. Every
per-sample term is shaped (B,) before its mean (the reference broadcasts
a (B,) prediction against a (B, 1) label in two places; the JAX package
and this port pair them per sample). The reference's inverted-angle
selection is kept: ``inverted_angle_mode='reference_max'`` keeps the
LARGER of the losses at theta and theta + pi (tp8.py:288), ``'min'`` the
smaller.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from alignnet3d_tpu_torch.ops.angle_codec import (
    angle2class,
    logits_to_angle,
    soft_angle_targets,
)
from alignnet3d_tpu_torch.ops.transforms import rotate_points_z, transform_pcs


@dataclasses.dataclass(frozen=True)
class LossSpec:
    loss: str = "separate"  # 'separate' | 'p2p'
    num_bins: int = 50
    angle_factor: float = 1.0
    early_stage_factor: float = 0.5
    accept_inverted_angle: bool = False
    soft_angle_classes: bool = False
    soft_angle_sigma_deg: float = 5.0
    inverted_angle_mode: str = "reference_max"  # 'reference_max' | 'min'
    composite_translation: bool = False
    flip_aware_composite: bool = False
    # weight of the per-view canonical-completion chamfer term; the
    # completion head is not ported, so only 0 is taken
    completion_weight: float = 0.0
    center_consistency_weight: float = 0.0
    center_consistency_frame: str = "canonical"  # 'canonical' | 'world'

    @classmethod
    def from_config(cls, cfg: Any) -> "LossSpec":
        opts = cfg.training.loss.options

        def opt(name, default):
            return getattr(opts, name) if opts.has(name) else default

        return cls(
            loss=cfg.training.loss.loss,
            num_bins=cfg.model.angles.num_bins,
            angle_factor=cfg.model.options.angle_factor,
            early_stage_factor=cfg.model.options.early_stage_factor,
            accept_inverted_angle=cfg.model.angles.accept_inverted_angle,
            soft_angle_classes=opts.soft_angle_classes,
            soft_angle_sigma_deg=opts.soft_angle_classes_sigma_in_degree,
            inverted_angle_mode=opt("inverted_angle_mode", "reference_max"),
            composite_translation=opt("composite_translation", False),
            flip_aware_composite=opt("flip_aware_composite", False),
            completion_weight=float(opt("completion_weight", 0.0)),
            center_consistency_weight=float(
                opt("center_consistency_weight", 0.0)),
            center_consistency_frame=opt("center_consistency_frame",
                                         "canonical"),
        )

    def __post_init__(self):
        # flip_aware rebases the COMPOSITE stage-3 target; without
        # composite_translation it would be silently ignored
        if self.flip_aware_composite and not self.composite_translation:
            raise ValueError(
                "flip_aware_composite requires composite_translation=true"
            )
        if self.center_consistency_frame not in ("canonical", "world"):
            raise ValueError(
                "center_consistency_frame must be 'canonical' or 'world', "
                f"got {self.center_consistency_frame!r}"
            )


def huber(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean huber loss (reference huber_loss, tp8.py:173-178)."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return torch.mean(0.5 * torch.square(quadratic) + delta * linear)


def _angle_loss(logits: torch.Tensor, target_angles: torch.Tensor,
                spec: LossSpec) -> torch.Tensor:
    """Bin cross-entropy + 20 x huber on the normalised residual of the
    TARGET bin (reference _tf_get_angle_loss, tp8.py:266-281).
    target_angles (B,); returns (total, class, residual)."""
    num_bins = spec.num_bins
    class_logits = logits[:, :num_bins]
    residuals_normalized = logits[:, num_bins:]
    target_classes, target_residuals = angle2class(target_angles, num_bins)
    logp = F.log_softmax(class_logits, dim=-1)
    if spec.soft_angle_classes:
        # degree targets on the degree grid (the JAX package's reading of
        # the reference's radian/degree mix, tp8.py:253-263)
        targets_deg = torch.rad2deg(torch.remainder(target_angles, 2.0 * np.pi))
        dist = soft_angle_targets(targets_deg, num_bins,
                                  spec.soft_angle_sigma_deg)
        class_loss = torch.mean(-torch.sum(dist * logp, dim=-1))
    else:
        class_loss = torch.mean(
            -torch.gather(logp, 1, target_classes[:, None].long())[:, 0])
    onehot = F.one_hot(target_classes.long(), num_bins).to(logits.dtype)
    residual_label = target_residuals / (np.pi / num_bins)
    pred_residual = torch.sum(residuals_normalized * onehot, dim=1)
    residual_loss = huber(pred_residual - residual_label, delta=1.0)
    return torch.stack(
        [class_loss + 20.0 * residual_loss, class_loss, residual_loss])


def _angle_losses(logits, target_angles, spec: LossSpec) -> torch.Tensor:
    """Optionally the loss at theta and theta + pi, one of them selected
    (reference tf_get_angle_losses, tp8.py:284-291)."""
    losses = _angle_loss(logits, target_angles, spec)
    if spec.accept_inverted_angle:
        losses_180 = _angle_loss(logits, target_angles + np.pi, spec)
        if spec.inverted_angle_mode == "reference_max":
            pick_first = losses[0] > losses_180[0]  # the reference's larger
        else:
            pick_first = losses[0] < losses_180[0]
        losses = torch.where(pick_first, losses, losses_180)
    return losses  # (3,): total, class, residual


def loss_separate(pcs1, pcs2, translations, rel_angles, pc1_centers,
                  pc2_centers, pc1_angles, pc2_angles, end_points,
                  spec: LossSpec):
    """Multi-stage loss (reference _get_loss_separate, tp8.py:304-354).
    Returns (scalar loss, aux dict of per-stage scalars for logging)."""
    if spec.completion_weight > 0.0:
        raise NotImplementedError(
            "completion_weight > 0 needs the completion head, which is not "
            "ported (ROADMAP.md, Queue 1)")
    batch_size = translations.shape[0]
    pc1_angles = pc1_angles.reshape(-1)
    pc2_angles = pc2_angles.reshape(-1)
    rel_angles = rel_angles.reshape(-1)

    s1_t = 0.5 * (huber(end_points["pred_s1_pc1centers"] - pc1_centers, 1.0)
                  + huber(end_points["pred_s1_pc2centers"] - pc2_centers, 1.0))
    pc1_s2_t = huber(end_points["pred_s2_pc1centers"] - pc1_centers, 1.0)
    pc2_s2_t = huber(end_points["pred_s2_pc2centers"] - pc2_centers, 1.0)
    s2_t = 0.5 * (pc1_s2_t + pc2_s2_t)

    a1 = _angle_losses(end_points["pred_pc1angle_logits"], pc1_angles, spec)
    a2 = _angle_losses(end_points["pred_pc2angle_logits"], pc2_angles, spec)
    s2_a = 0.5 * (a1[0] + a2[0])

    scale = np.pi / spec.num_bins
    pc1_pred = logits_to_angle(end_points["pred_pc1angle_logits"],
                               spec.num_bins, residual_scale=scale)
    pc2_pred = logits_to_angle(end_points["pred_pc2angle_logits"],
                               spec.num_bins, residual_scale=scale)

    if spec.composite_translation:
        # train the (t, center) pair on the translation re-based to the GT
        # rotation centre, t' = -s + Rz(a) s + t with s = c_gt - c_pred,
        # the quantity the metric scores (JAX package, losses.py:245-285)
        rebase_angle = rel_angles
        if spec.flip_aware_composite:
            # rebase at the hypothesis the network commits to (theta or
            # theta + pi); a routing indicator only, without gradient
            remaining_pred = logits_to_angle(
                end_points["pred_remaining_angle_logits"], spec.num_bins,
                residual_scale=scale)
            pred_total = (pc2_pred - pc1_pred) + remaining_pred
            diff = torch.remainder(pred_total - rel_angles + np.pi,
                                   2.0 * np.pi) - np.pi
            flip = (torch.abs(diff) > (np.pi / 2.0)).detach()
            rebase_angle = rel_angles + np.pi * flip.to(rel_angles.dtype)
        s = pc1_centers - end_points["pred_s2_pc1centers"]
        ca, sa = torch.cos(rebase_angle), torch.sin(rebase_angle)
        rot_s = torch.stack([ca * s[:, 0] - sa * s[:, 1],
                             sa * s[:, 0] + ca * s[:, 1],
                             s[:, 2]], dim=1)
        rebased = end_points["pred_translations"] - s + rot_s
        s3_t = huber(rebased - translations, 2.0)
    else:
        s3_t = huber(end_points["pred_translations"] - translations, 2.0)

    remaining_target = (pc2_angles - pc1_angles) - (pc2_pred - pc1_pred)
    a3 = _angle_losses(end_points["pred_remaining_angle_logits"],
                       remaining_target, spec)

    cons_loss = None
    if spec.center_consistency_weight > 0.0:
        # the differential component of the two views' s2-centre errors,
        # in the GT object frame ('canonical') or the world frame
        e1 = end_points["pred_s2_pc1centers"] - pc1_centers
        e2 = end_points["pred_s2_pc2centers"] - pc2_centers
        if spec.center_consistency_frame == "canonical":
            e1 = rotate_points_z(e1[:, None, :], -pc1_angles)[:, 0, :]
            e2 = rotate_points_z(e2[:, None, :], -pc2_angles)[:, 0, :]
        cons_loss = huber(e1 - e2, delta=1.0)

    esf = spec.early_stage_factor
    loss_translation = esf * (s1_t + s2_t) + s3_t
    if cons_loss is not None:
        loss_translation = (loss_translation
                            + spec.center_consistency_weight * cons_loss)
    loss_angle = esf * s2_a + a3[0]
    loss = loss_translation + spec.angle_factor * loss_angle
    # the reference divides the batch-mean loss by the batch size again
    # (tp8.py:334); it only rescales the learning rate
    per_transform_loss = loss / batch_size

    aux = {
        "losses/translation": loss_translation,
        "losses/angle": loss_angle,
        "losses_stages/stage1_transl_loss": s1_t,
        "losses_stages/stage2_pc1_transl_loss": pc1_s2_t,
        "losses_stages/stage2_pc2_transl_loss": pc2_s2_t,
        "losses_stages/stage3_transl_loss": s3_t,
        "losses_stages/stage2_pc1_angle_loss": a1[0],
        "losses_stages/stage2_pc1_angle_class_loss": a1[1],
        "losses_stages/stage2_pc1_angle_residual_loss": a1[2],
        "losses_stages/stage2_pc2_angle_loss": a2[0],
        "losses_stages/stage2_pc2_angle_class_loss": a2[1],
        "losses_stages/stage2_pc2_angle_residual_loss": a2[2],
        "losses_stages/stage3_angle_loss": a3[0],
        "losses_stages/stage3_angle_class_loss": a3[1],
        "losses_stages/stage3_angle_residual_loss": a3[2],
    }
    if cons_loss is not None:
        aux["losses_stages/center_consistency_loss"] = cons_loss
    return per_transform_loss, aux


def loss_p2p(pcs1, pcs2, translations, rel_angles, pc1_centers, pc2_centers,
             pc1_angles, pc2_angles, end_points, spec: LossSpec):
    """Dense point-to-point loss (reference _get_loss_p2p, tp8.py:374-398):
    pcs1 moved by the predicted and by the GT motion, the mean of squared
    per-coordinate norms over the POINT axis (the reference's tf.norm
    axis=1). Its '180' variant equals the first, so it is not computed."""
    batch_size = translations.shape[0]
    scale = np.pi / spec.num_bins
    nb = spec.num_bins
    pred_angles = (
        logits_to_angle(end_points["pred_pc2angle_logits"], nb, scale)
        - logits_to_angle(end_points["pred_pc1angle_logits"], nb, scale)
        + logits_to_angle(end_points["pred_remaining_angle_logits"], nb,
                          scale)
    )
    pred = transform_pcs(pcs1, end_points["pred_translations"], pred_angles,
                         end_points["pred_s2_pc1centers"])
    gt = transform_pcs(pcs1, translations, rel_angles.reshape(-1),
                       pc1_centers)
    point_distances = torch.linalg.vector_norm(pred - gt, dim=1)
    loss = torch.mean(torch.square(point_distances))
    return loss / batch_size, {"losses/p2p": loss}


def get_loss(*args, spec: LossSpec):
    """Dispatch (reference get_loss, tp8.py:401-407)."""
    if spec.loss == "separate":
        return loss_separate(*args, spec=spec)
    if spec.loss == "p2p":
        return loss_p2p(*args, spec=spec)
    raise ValueError(f"unknown loss {spec.loss!r}")
