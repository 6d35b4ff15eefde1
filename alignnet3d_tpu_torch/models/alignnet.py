"""The AlignNet model: Siamese 3-stage canonicalising encoder +
relative-pose head (reference models/tp8.py:101-158).

Counterpart of ``alignnet3d_tpu/models/alignnet.py``, PointNet and DGCNN
backbones. With ``stack_siamese=True`` (the default) both clouds run
through the shared encoder as one stacked 2B batch, so train-mode BN
statistics are shared; with ``False`` the encoder runs once a view, as the
reference graph does, and the second call's BNs start from the running
statistics the first call moved.
The module tree carries the flax names (``siamese.transformer1``, its
backbone ``PointNetBackbone_0`` or ``DGCNNBackbone_0``, ``remaining`` ...),
and ``forward`` returns the same ``end_points`` keys. With
``completion_points`` m > 0 the encoder also decodes each view's embedding
into m canonical-frame points (``siamese.completion``, an
``MLPHead((256, 3 m))``), returned as ``pred_pc{1,2}completions`` (B, m, 3)
for the completion loss; the serving path does not fold that head.

``spec.compute_dtype`` ("float32" or "bfloat16", ``tpu.compute_dtype``)
is the dtype of the backbones and heads (``models/backbones.py``); the
centres, the de-rotation and every output are float32. The serving path
folds the BNs (``alignnet3d_tpu_torch.serving``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from alignnet3d_tpu_torch.models.backbones import MLPHead, make_backbone
from alignnet3d_tpu_torch.ops.angle_codec import logits_to_angle
from alignnet3d_tpu_torch.ops.transforms import rotate_points_z


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model hyperparameters, read from the same config keys as the
    JAX package's ModelSpec (configs/default.json: model.*)."""

    backbone: str = "pointnet"
    num_points: int = 512
    num_bins: int = 50
    s1_backbone: Sequence[int] = (64, 128, 256)
    s1_mlp: Sequence[int] = (512, 256)
    s1_dropout_keep: float = 0.7
    s2_backbone: Sequence[int] = (64, 128, 512)
    s2_mlp: Sequence[int] = (512, 256)
    s2_dropout_keep: float = 0.7
    embedding: Sequence[int] = (64, 128, 1024)
    remaining_mlp: Sequence[int] = (512, 256)
    remaining_dropout_keep: float = 0.7
    compute_dtype: str = "float32"
    dgcnn_approx_knn: bool = False
    dgcnn_knn_impl: str = "pallas"
    dgcnn_fused_train: bool = False
    stable_max_grad: bool = False
    completion_points: int = 0
    stack_siamese: bool = True

    @classmethod
    def from_config(cls, cfg: Any) -> "ModelSpec":
        opts = cfg.model.options
        return cls(
            backbone=cfg.model.backbone,
            num_points=cfg.model.num_points,
            num_bins=cfg.model.angles.num_bins,
            s1_backbone=tuple(opts.s1transformer[0]),
            s1_mlp=tuple(opts.s1transformer[1][0]),
            s1_dropout_keep=opts.s1transformer[1][1],
            s2_backbone=tuple(opts.s2transformer[0]),
            s2_mlp=tuple(opts.s2transformer[1][0]),
            s2_dropout_keep=opts.s2transformer[1][1],
            embedding=tuple(opts.embedding),
            remaining_mlp=tuple(opts.remaining_transform_prediction[0]),
            remaining_dropout_keep=opts.remaining_transform_prediction[1],
            compute_dtype=cfg.tpu.compute_dtype if cfg.has("tpu") else "float32",
            dgcnn_approx_knn=bool(
                opts.has("dgcnn_approx_knn") and opts.dgcnn_approx_knn
            ),
            dgcnn_knn_impl=(
                str(opts.dgcnn_knn_impl)
                if opts.has("dgcnn_knn_impl") else "pallas"
            ),
            dgcnn_fused_train=bool(
                opts.has("dgcnn_fused_train") and opts.dgcnn_fused_train
            ),
            stable_max_grad=bool(
                opts.has("stable_max_grad") and opts.stable_max_grad
            ),
            completion_points=(
                int(opts.completion_points)
                if opts.has("completion_points") else 0
            ),
        )

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]


def backbone_name(spec: ModelSpec) -> str:
    """The flax name of the spec's backbone module: its class name + _0."""
    names = {"pointnet": "PointNetBackbone_0", "dgcnn": "DGCNNBackbone_0"}
    if spec.backbone not in names:
        raise ValueError(f"unknown backbone {spec.backbone!r}")
    return names[spec.backbone]


def _backbone(spec: ModelSpec, sizes: Sequence[int]) -> nn.Module:
    return make_backbone(spec.backbone, 3, sizes,
                         approx_knn=spec.dgcnn_approx_knn,
                         knn_impl=spec.dgcnn_knn_impl,
                         fused_train=spec.dgcnn_fused_train,
                         stable_max_grad=spec.stable_max_grad,
                         dtype=spec.dtype)


class TransformerNet(nn.Module):
    """Backbone -> MLP head (reference get_transformer_net, tp8.py:89-98).
    The head is 3 wide, plus 2*num_bins when it predicts angles."""

    def __init__(self, spec: ModelSpec, backbone_sizes: Sequence[int],
                 mlp_sizes: Sequence[int], dropout_keep: float,
                 with_angles: bool):
        super().__init__()
        head_width = 3 + (2 * spec.num_bins if with_angles else 0)
        self.backbone_name = backbone_name(spec)
        self.add_module(self.backbone_name, _backbone(spec, backbone_sizes))
        self.MLPHead_0 = MLPHead(backbone_sizes[-1],
                                 (*mlp_sizes, head_width), dropout_keep,
                                 dtype=spec.dtype)

    def forward(self, points: torch.Tensor, momentum: float) -> torch.Tensor:
        feat = getattr(self, self.backbone_name)(points, momentum)
        return self.MLPHead_0(feat, momentum)


class EmbeddingNet(nn.Module):
    """3-stage canonicaliser + embedding (reference get_embedding_net,
    tp8.py:101-132): mean-centre -> transformer1 -> centre estimate;
    re-centre -> transformer2 -> refined centre + yaw logits; re-centre and
    de-rotate by the predicted yaw -> embedding backbone."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.transformer1 = TransformerNet(
            spec, spec.s1_backbone, spec.s1_mlp, spec.s1_dropout_keep,
            with_angles=False)
        self.transformer2 = TransformerNet(
            spec, spec.s2_backbone, spec.s2_mlp, spec.s2_dropout_keep,
            with_angles=True)
        self.backbone_name = backbone_name(spec)
        self.add_module(self.backbone_name, _backbone(spec, spec.embedding))
        self.completion = (
            MLPHead(spec.embedding[-1], (256, 3 * spec.completion_points),
                    dtype=spec.dtype)
            if spec.completion_points > 0 else None)

    def forward(self, points: torch.Tensor, momentum: float):
        spec = self.spec
        center_mean = torch.mean(points, dim=1)
        s1_center = self.transformer1(points - center_mean[:, None, :],
                                      momentum) + center_mean
        s2_out = self.transformer2(points - s1_center[:, None, :], momentum)
        s2_center = s2_out[:, :3] + s1_center
        s2_angle_logits = s2_out[:, 3:]
        s2_angles = logits_to_angle(s2_angle_logits.to(torch.float32),
                                    spec.num_bins,
                                    residual_scale=np.pi / spec.num_bins)
        normalized = rotate_points_z(points - s2_center[:, None, :], -s2_angles)
        embedding = getattr(self, self.backbone_name)(normalized, momentum)
        completion = None
        if self.completion is not None:
            # canonical-frame shape completion decoded from the embedding
            # alone, so matching the canonical target pulls s2_center and
            # s2_angles (through ``normalized``) onto the shape
            comp = self.completion(embedding, momentum)
            completion = comp.reshape(comp.shape[0], spec.completion_points, 3)
        return embedding, s1_center, s2_center, s2_angle_logits, completion


class AlignNet(nn.Module):
    """Siamese relative-pose network (reference get_model, tp8.py:135-158).
    ``forward(pcs1, pcs2, momentum)`` returns the reference's end_points;
    ``train()``/``eval()`` pick batch or running BN statistics."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.siamese = EmbeddingNet(spec)
        self.remaining = MLPHead(
            2 * spec.embedding[-1],
            (*spec.remaining_mlp, 3 + 2 * spec.num_bins),
            spec.remaining_dropout_keep, dtype=spec.dtype,
        )

    def forward(self, pcs1: torch.Tensor, pcs2: torch.Tensor,
                momentum: float = 0.9) -> dict[str, torch.Tensor]:
        if self.spec.stack_siamese:
            b = pcs1.shape[0]
            stacked = self.siamese(torch.cat([pcs1, pcs2], dim=0), momentum)
            view1 = [None if t is None else t[:b] for t in stacked]
            view2 = [None if t is None else t[b:] for t in stacked]
        else:
            view1 = self.siamese(pcs1, momentum)
            view2 = self.siamese(pcs2, momentum)
        (emb1, s1c1, s2c1, logits1, comp1), (emb2, s1c2, s2c2, logits2,
                                             comp2) = view1, view2
        out = self.remaining(torch.cat([emb1, emb2], dim=-1),
                             momentum).to(torch.float32)
        f32 = torch.float32
        end_points = {
            "pred_s1_pc1centers": s1c1.to(f32),
            "pred_s1_pc2centers": s1c2.to(f32),
            "pred_s2_pc1centers": s2c1.to(f32),
            "pred_s2_pc2centers": s2c2.to(f32),
            "pred_pc1angle_logits": logits1.to(f32),
            "pred_pc2angle_logits": logits2.to(f32),
            # translation = head delta + (s2_center2 - s2_center1), tp8.py:155
            "pred_translations": out[:, :3] + (s2c2 - s2c1).to(f32),
            "pred_remaining_angle_logits": out[:, 3:],
        }
        if comp1 is not None:
            end_points["pred_pc1completions"] = comp1.to(f32)
            end_points["pred_pc2completions"] = comp2.to(f32)
        return end_points
