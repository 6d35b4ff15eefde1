"""Serving path: the BN-folded inference engine.

Counterpart of ``alignnet3d_tpu/serving.py`` (PointNet branch). At serving
time every BatchNorm is an affine map with frozen statistics and folds into
the dense layer before it:

    y = ((x W + b) - mu) * g / sqrt(v + eps) + beta
      = x (W * s) + (b - mu) * s + beta,     s = g / sqrt(v + eps)

The encoder then is three relu-dense chains + max over points per cloud
(s1, s2 and the embedding), each one launch of ``fused_pointnet`` (the
CUDA kernel on the card), plus the small MLP heads in ``torch.matmul`` and
the batched de-rotation.

``build_inference_fn(spec, state_dict, device=...)`` returns a function
with the eval-mode semantics of ``AlignNet`` in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from alignnet3d_tpu_torch.models.alignnet import ModelSpec
from alignnet3d_tpu_torch.ops.angle_codec import logits_to_angle
from alignnet3d_tpu_torch.ops.pointnet_kernels import fused_pointnet, round_to
from alignnet3d_tpu_torch.ops.transforms import rotate_points_z

BN_EPS = 1e-3


def _np(state_dict, key: str) -> np.ndarray:
    return state_dict[key].detach().cpu().numpy().astype(np.float32)


def _fold_dense_bn(state_dict, dense: str, bn: str):
    """Fold (dense -> EmaBatchNorm) into one (W (in, out), b), in numpy
    float32 as the JAX package folds."""
    w = _np(state_dict, f"{dense}.weight").T
    b = _np(state_dict, f"{dense}.bias")
    scale = _np(state_dict, f"{bn}.scale")
    beta = _np(state_dict, f"{bn}.bias")
    mu = _np(state_dict, f"{bn}.mean")
    var = _np(state_dict, f"{bn}.var")
    s = scale / np.sqrt(var + BN_EPS)
    return w * s[None, :], (b - mu) * s + beta


def _fold_chain(state_dict, prefix: str, n_layers: int, device,
                conv: bool = True):
    """Fold an n-layer dense+BN chain ``{prefix}.{conv|fc}{i}``/``bn{i}``
    into lists of contiguous float32 tensors on ``device``."""
    base = "conv" if conv else "fc"
    weights, biases = [], []
    for i in range(1, n_layers + 1):
        w, b = _fold_dense_bn(state_dict, f"{prefix}.{base}{i}",
                              f"{prefix}.bn{i}")
        weights.append(torch.as_tensor(np.ascontiguousarray(w), device=device))
        biases.append(torch.as_tensor(b, device=device))
    return weights, biases


class _FoldedMLPHead:
    """Folded BN hidden layers + the final linear layer (dropout is a no-op
    at inference)."""

    def __init__(self, state_dict, prefix: str, n_hidden: int, device):
        self.weights, self.biases = _fold_chain(state_dict, prefix, n_hidden,
                                                device, conv=False)
        final = f"{prefix}.fc{n_hidden + 1}"
        self.w_final = torch.as_tensor(
            np.ascontiguousarray(_np(state_dict, f"{final}.weight").T),
            device=device)
        self.b_final = torch.as_tensor(_np(state_dict, f"{final}.bias"),
                                       device=device)

    def __call__(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        h = round_to(x, compute_dtype)
        for w, b in zip(self.weights, self.biases):
            h = torch.clamp_min(torch.matmul(h, round_to(w, compute_dtype)) + b,
                                0.0)
            h = round_to(h, compute_dtype)
        return torch.matmul(h, round_to(self.w_final, compute_dtype)) + self.b_final


class _FoldedTransformer:
    def __init__(self, state_dict, prefix: str, n_backbone: int, n_mlp: int,
                 device):
        self.bb_w, self.bb_b = _fold_chain(
            state_dict, f"{prefix}.PointNetBackbone_0", n_backbone, device)
        self.head = _FoldedMLPHead(state_dict, f"{prefix}.MLPHead_0", n_mlp,
                                   device)

    def __call__(self, points: torch.Tensor, compute_dtype) -> torch.Tensor:
        feat = fused_pointnet(points.contiguous(), self.bb_w, self.bb_b,
                              compute_dtype)
        return self.head(feat, compute_dtype)


def build_inference_fn(spec: ModelSpec, state_dict,
                       compute_dtype: torch.dtype = torch.float32, *,
                       device: torch.device | str):
    """Return ``fn(pcs1, pcs2) -> end_points`` over folded weights on
    ``device``. pcs are (B, N, 3) float32 tensors on that device."""
    if spec.backbone == "dgcnn":
        raise NotImplementedError(
            "folded DGCNN serving is not ported yet (ROADMAP.md, Queue 1: "
            "DGCNN branch)")
    if spec.backbone != "pointnet":
        raise ValueError(f"unknown backbone {spec.backbone!r}")
    t1 = _FoldedTransformer(state_dict, "siamese.transformer1",
                            len(spec.s1_backbone), len(spec.s1_mlp), device)
    t2 = _FoldedTransformer(state_dict, "siamese.transformer2",
                            len(spec.s2_backbone), len(spec.s2_mlp), device)
    emb_w, emb_b = _fold_chain(state_dict, "siamese.PointNetBackbone_0",
                               len(spec.embedding), device)
    remaining = _FoldedMLPHead(state_dict, "remaining",
                               len(spec.remaining_mlp), device)
    residual_scale = np.pi / spec.num_bins

    def encode(points):
        center_mean = torch.mean(points, dim=1)
        s1_center = t1(points - center_mean[:, None, :],
                       compute_dtype)[:, :3] + center_mean
        s2_out = t2(points - s1_center[:, None, :], compute_dtype)
        s2_center = s2_out[:, :3] + s1_center
        s2_logits = s2_out[:, 3:]
        s2_angles = logits_to_angle(s2_logits, spec.num_bins, residual_scale)
        normalized = rotate_points_z(points - s2_center[:, None, :], -s2_angles)
        emb = fused_pointnet(normalized.contiguous(), emb_w, emb_b,
                             compute_dtype)
        return emb, s1_center, s2_center, s2_logits

    @torch.no_grad()
    def forward(pcs1: torch.Tensor, pcs2: torch.Tensor):
        b = pcs1.shape[0]
        emb, s1c, s2c, logits = encode(torch.cat([pcs1, pcs2], dim=0))
        out = remaining(torch.cat([emb[:b], emb[b:]], dim=-1), compute_dtype)
        return {
            "pred_s1_pc1centers": s1c[:b],
            "pred_s1_pc2centers": s1c[b:],
            "pred_s2_pc1centers": s2c[:b],
            "pred_s2_pc2centers": s2c[b:],
            "pred_pc1angle_logits": logits[:b],
            "pred_pc2angle_logits": logits[b:],
            "pred_translations": out[:, :3] + (s2c[b:] - s2c[:b]),
            "pred_remaining_angle_logits": out[:, 3:],
        }

    return forward
