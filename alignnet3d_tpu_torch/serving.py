"""Serving path: the BN-folded inference engine.

Counterpart of ``alignnet3d_tpu/serving.py`` (no ``quantize``). At serving
time every BatchNorm is an affine map with frozen statistics and folds into
the dense layer before it:

    y = ((x W + b) - mu) * g / sqrt(v + eps) + beta
      = x (W * s) + (b - mu) * s + beta,     s = g / sqrt(v + eps)

The encoder then runs three backbones per cloud (s1, s2 and the
embedding), plus the small MLP heads in ``torch.matmul`` and the batched
de-rotation. A PointNet backbone is one launch of ``fused_pointnet``; a
DGCNN backbone is ``knn_points``, then ``fused_edge_stage`` (both CUDA
kernels on the card), then its last folded dense layer and the max over
points.

``FoldedAlignNet`` is that forward as an ``nn.Module``: its folded
weights are buffers, its devices come from its inputs and buffers, and its
forward returns the outputs as a tuple in ``OUTPUT_KEYS`` order, so
``torch.export`` traces it (``export.py``). ``build_inference_fn(spec,
state_dict, device=...)`` wraps it in ``torch.no_grad`` and returns a
function with the eval-mode semantics of ``AlignNet``: the eager path and
the exported path run one forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from alignnet3d_tpu_torch.export import OUTPUT_KEYS
from alignnet3d_tpu_torch.models.alignnet import ModelSpec, backbone_name
from alignnet3d_tpu_torch.ops.angle_codec import logits_to_angle
from alignnet3d_tpu_torch.ops.edge_conv_kernels import fused_edge_stage
from alignnet3d_tpu_torch.ops.knn_kernels import knn_points
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


class _FoldedChain(nn.Module):
    """A folded n-layer dense+BN chain (``_fold_chain``), its weights and
    biases held as buffers ``w{i}``, ``b{i}``."""

    def __init__(self, state_dict, prefix: str, n_layers: int, device,
                 compute_dtype, conv: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_layers = n_layers
        weights, biases = _fold_chain(state_dict, prefix, n_layers, device,
                                      conv)
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)

    def chain(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        return ([getattr(self, f"w{i}") for i in range(self.n_layers)],
                [getattr(self, f"b{i}") for i in range(self.n_layers)])


class _FoldedMLPHead(_FoldedChain):
    """Folded BN hidden layers + the final linear layer (dropout is a no-op
    at inference)."""

    def __init__(self, state_dict, prefix: str, n_hidden: int, device,
                 compute_dtype):
        super().__init__(state_dict, prefix, n_hidden, device, compute_dtype,
                         conv=False)
        final = f"{prefix}.fc{n_hidden + 1}"
        self.register_buffer("w_final", torch.as_tensor(
            np.ascontiguousarray(_np(state_dict, f"{final}.weight").T),
            device=device))
        self.register_buffer("b_final", torch.as_tensor(
            _np(state_dict, f"{final}.bias"), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        h = round_to(x, dtype)
        for w, b in zip(*self.chain()):
            h = torch.clamp_min(torch.matmul(h, round_to(w, dtype)) + b, 0.0)
            h = round_to(h, dtype)
        return torch.matmul(h, round_to(self.w_final, dtype)) + self.b_final


class _FoldedPointNet(_FoldedChain):
    """Folded PointNet backbone: one fused relu-dense chain + max."""

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return fused_pointnet(points.contiguous(), *self.chain(),
                              self.compute_dtype)


class _FoldedDGCNN(_FoldedChain):
    """Folded DGCNN backbone: the exact kNN graph, the fused edge stage of
    conv1/conv2 (in float32, as the JAX kernel runs it), then conv3 in
    ``torch.matmul`` and the max over points. The reference's 3-layer shape
    (tp8.py:30-46) is the only one any config uses."""

    k = 20

    def __init__(self, state_dict, prefix: str, n_layers: int, device,
                 compute_dtype):
        if n_layers != 3:
            raise ValueError("the folded dgcnn path expects 3 conv layers")
        super().__init__(state_dict, prefix, n_layers, device, compute_dtype)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        (w1, w2, w3), (b1, b2, b3) = self.chain()
        x = points.to(torch.float32).contiguous()
        nn_idx = knn_points(x, min(self.k, x.shape[1]))
        h = fused_edge_stage(x, nn_idx, w1, b1, w2, b2)
        h = torch.matmul(round_to(h, self.compute_dtype),
                         round_to(w3, self.compute_dtype))
        return torch.amax(torch.clamp_min(h + b3, 0.0), dim=1)


def _folded_backbone(spec: ModelSpec, state_dict, prefix: str,
                     n_layers: int, device, compute_dtype):
    cls = _FoldedDGCNN if spec.backbone == "dgcnn" else _FoldedPointNet
    return cls(state_dict, f"{prefix}.{backbone_name(spec)}", n_layers,
               device, compute_dtype)


class _FoldedTransformer(nn.Module):
    def __init__(self, spec: ModelSpec, state_dict, prefix: str,
                 n_backbone: int, n_mlp: int, device, compute_dtype):
        super().__init__()
        self.backbone = _folded_backbone(spec, state_dict, prefix, n_backbone,
                                         device, compute_dtype)
        self.head = _FoldedMLPHead(state_dict, f"{prefix}.MLPHead_0", n_mlp,
                                   device, compute_dtype)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(points))


class FoldedAlignNet(nn.Module):
    """The folded eval-mode forward over ``state_dict``'s weights on
    ``device``: ``(pcs1, pcs2)``, each (B, N, 3) float32 on that device, to
    the outputs in ``OUTPUT_KEYS`` order."""

    def __init__(self, spec: ModelSpec, state_dict,
                 compute_dtype: torch.dtype = torch.float32, *,
                 device: torch.device | str):
        super().__init__()
        self.num_bins = spec.num_bins
        self.residual_scale = np.pi / spec.num_bins
        self.t1 = _FoldedTransformer(spec, state_dict, "siamese.transformer1",
                                     len(spec.s1_backbone), len(spec.s1_mlp),
                                     device, compute_dtype)
        self.t2 = _FoldedTransformer(spec, state_dict, "siamese.transformer2",
                                     len(spec.s2_backbone), len(spec.s2_mlp),
                                     device, compute_dtype)
        self.embed = _folded_backbone(spec, state_dict, "siamese",
                                      len(spec.embedding), device,
                                      compute_dtype)
        self.remaining = _FoldedMLPHead(state_dict, "remaining",
                                        len(spec.remaining_mlp), device,
                                        compute_dtype)

    def encode(self, points: torch.Tensor):
        center_mean = torch.mean(points, dim=1)
        s1_center = self.t1(points - center_mean[:, None, :])[:, :3] \
            + center_mean
        s2_out = self.t2(points - s1_center[:, None, :])
        s2_center = s2_out[:, :3] + s1_center
        s2_logits = s2_out[:, 3:]
        s2_angles = logits_to_angle(s2_logits, self.num_bins,
                                    self.residual_scale)
        normalized = rotate_points_z(points - s2_center[:, None, :],
                                     -s2_angles)
        return self.embed(normalized), s1_center, s2_center, s2_logits

    def forward(self, pcs1: torch.Tensor, pcs2: torch.Tensor):
        b = pcs1.shape[0]
        emb, s1c, s2c, logits = self.encode(torch.cat([pcs1, pcs2], dim=0))
        out = self.remaining(torch.cat([emb[:b], emb[b:]], dim=-1))
        return (s1c[:b], s1c[b:], s2c[:b], s2c[b:], logits[:b], logits[b:],
                out[:, :3] + (s2c[b:] - s2c[:b]), out[:, 3:])


def build_inference_fn(spec: ModelSpec, state_dict,
                       compute_dtype: torch.dtype = torch.float32, *,
                       device: torch.device | str):
    """Return ``fn(pcs1, pcs2) -> end_points`` over folded weights on
    ``device``. pcs are (B, N, 3) float32 tensors on that device."""
    module = FoldedAlignNet(spec, state_dict, compute_dtype, device=device)

    def forward(pcs1: torch.Tensor, pcs2: torch.Tensor):
        with torch.no_grad():
            return dict(zip(OUTPUT_KEYS, module(pcs1, pcs2)))

    return forward
