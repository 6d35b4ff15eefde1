"""Point-cloud encoder backbones: PointNet and DGCNN.

Counterpart of ``alignnet3d_tpu/models/backbones.py``. The reference's
per-point "shared MLP" (models/tp8.py:49-59) is a stack of dense layers
over the channel axis followed by a max over the points; its DGCNN
(tp8.py:30-46) runs edge convs over a kNN graph first. Submodule names
(``conv{i}``, ``bn{i}``, ``fc{i}``) are the flax names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from alignnet3d_tpu_torch.models.batchnorm import EmaBatchNorm
from alignnet3d_tpu_torch.ops.edge_train_kernels import fused_edge_stage_train
from alignnet3d_tpu_torch.ops.knn import gather_rows, knn, pairwise_distance
from alignnet3d_tpu_torch.ops.knn_kernels import knn_points
from alignnet3d_tpu_torch.ops.stable_max import stable_max


def _pool(stable: bool):
    """The max-pool of the training graph: ``stable_max`` gives the
    gradient to the first argmax (``model.options.stable_max_grad``),
    ``torch.amax`` splits it over ties, as ``jnp.max`` does. Forward values
    are the same either way."""
    return stable_max if stable else torch.amax


class PointNetBackbone(nn.Module):
    """dense -> BN -> relu per point for each width, then the channel-wise
    max over the N points: (B, N, C) -> (B, layer_sizes[-1])."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 stable_max_grad: bool = False):
        super().__init__()
        self.num_layers = len(layer_sizes)
        self.stable_max_grad = stable_max_grad
        widths = (in_features, *layer_sizes)
        for i in range(self.num_layers):
            self.add_module(f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            self.add_module(f"bn{i + 1}", EmaBatchNorm(widths[i + 1]))

    def forward(self, points: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        x = points.to(torch.float32)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x, momentum))
        return _pool(self.stable_max_grad and self.training)(x, 1)


class DGCNNBackbone(nn.Module):
    """Dynamic-graph edge-conv stack (reference ``_get_dgcnn``,
    tp8.py:30-46): kNN on the raw xyz (k=20), edge features
    ``[x_i, x_j - x_i]``, dense -> BN -> relu on the edges for all but the
    last width, max over the neighbours, a last dense -> BN -> relu per
    point, max over the points: (B, N, C) -> (B, layer_sizes[-1]).

    ``knn_impl='pallas'`` (the default, the JAX package's name) builds the
    graph with ``knn_points``, the CUDA kernel on the card; ``'xla'`` takes
    ``knn(pairwise_distance(x))``. Both give the same neighbours, ties to
    the lower index.

    ``fused_train`` runs the two edge layers of a train-mode forward with
    exactly three widths through ``fused_edge_stage_train`` (the CUDA
    kernels on the card), with the same parameters and buffers; eval mode
    ignores it."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 k: int = 20, approx_knn: bool = False,
                 knn_impl: str = "pallas", fused_train: bool = False,
                 stable_max_grad: bool = False):
        super().__init__()
        if len(layer_sizes) < 2:
            raise ValueError("dgcnn needs >= 2 layers")
        if knn_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown knn_impl {knn_impl!r}")
        self.num_layers = len(layer_sizes)
        self.k = k
        self.approx_knn = approx_knn
        self.knn_impl = knn_impl
        self.fused_train = fused_train
        self.stable_max_grad = stable_max_grad
        widths = (2 * in_features, *layer_sizes)
        for i in range(self.num_layers):
            self.add_module(f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            self.add_module(f"bn{i + 1}", EmaBatchNorm(widths[i + 1]))

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, k') int64 neighbour indices, k' = min(k, N)."""
        k = min(self.k, x.shape[1])
        if self.knn_impl == "pallas" and not self.approx_knn:
            return knn_points(x.contiguous(), k)
        return knn(pairwise_distance(x), k, approximate=self.approx_knn)

    def forward(self, points: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        pool = _pool(self.stable_max_grad and self.training)
        x = points.to(torch.float32)
        nn_idx = self.graph(x.detach())
        if self.fused_train and self.training and self.num_layers == 3:
            h = self._fused_edge_layers(x, nn_idx, momentum)
        else:
            h = self._edge_layers(x, nn_idx, momentum, pool)
        i = self.num_layers
        h = getattr(self, f"conv{i}")(h)
        h = torch.relu(getattr(self, f"bn{i}")(h, momentum))
        return pool(h, 1)

    def _edge_layers(self, x, nn_idx, momentum, pool):
        # conv1 is linear in the edge feature [x_i, x_j - x_i]:
        #   conv1(edge_ij) = U_i + V_j - b,  U = conv1([x, -x]), V = conv1([0, x])
        # written as the JAX module writes it, which rounds differently from
        # conv1 on the materialised edge tensor
        conv1 = self.conv1
        u = conv1(torch.cat([x, -x], dim=-1))
        v = conv1(torch.cat([torch.zeros_like(x), x], dim=-1))
        bias1 = conv1(torch.zeros((1, 1, 2 * x.shape[-1]), dtype=x.dtype,
                                  device=x.device))
        h = u[:, :, None, :] + gather_rows(v, nn_idx) - bias1[:, :, None, :]
        h = torch.relu(self.bn1(h, momentum))
        for i in range(2, self.num_layers):
            h = getattr(self, f"conv{i}")(h)
            h = torch.relu(getattr(self, f"bn{i}")(h, momentum))
        return pool(h, 2)  # max over the neighbours

    def _fused_edge_layers(self, x, nn_idx, momentum):
        """conv1/bn1/conv2/bn2 and the max over k in one fused stage; its
        batch statistics feed the two BNs' running averages."""
        bn1, bn2 = self.bn1, self.bn2
        out, (mu1, var1, mu2, var2) = fused_edge_stage_train(
            x, nn_idx, self.conv1.weight.t(), self.conv1.bias, bn1.scale,
            bn1.bias, self.conv2.weight.t(), self.conv2.bias, bn2.scale,
            bn2.bias, eps=bn1.eps)
        bn1.ema_update(mu1, var1, momentum)
        bn2.ema_update(mu2, var2, momentum)
        return out


class Dropout(nn.Module):
    """flax's dropout: in training, keep each unit with probability
    ``keep`` and scale it by 1 / keep. The mask is drawn from
    ``self.generator`` when one is set (the trainer seeds it), else from
    PyTorch's default generator of the tensor's device."""

    def __init__(self, keep: float):
        super().__init__()
        self.keep = keep
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.keep >= 1.0:
            return x
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < self.keep
        return torch.where(mask, x / self.keep, torch.zeros_like(x))


class MLPHead(nn.Module):
    """FC stack with BN + relu on all but the last layer and dropout before
    the final linear layer (reference get_mlp, tp8.py:75-82).
    ``dropout_keep`` is the KEEP probability, as in the reference configs."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dropout_keep: float | None = None):
        super().__init__()
        self.num_layers = len(layer_sizes)
        widths = (in_features, *layer_sizes)
        for i in range(self.num_layers):
            self.add_module(f"fc{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            if i < self.num_layers - 1:
                self.add_module(f"bn{i + 1}", EmaBatchNorm(widths[i + 1]))
        self.dropout = (Dropout(dropout_keep)
                        if dropout_keep is not None else nn.Identity())

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        x = x.to(torch.float32)
        for i in range(1, self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x, momentum))
        x = self.dropout(x)
        return getattr(self, f"fc{self.num_layers}")(x)


def make_backbone(backbone: str, in_features: int,
                  layer_sizes: Sequence[int], approx_knn: bool = False,
                  knn_impl: str = "pallas", fused_train: bool = False,
                  stable_max_grad: bool = False) -> nn.Module:
    if backbone == "pointnet":
        return PointNetBackbone(in_features, layer_sizes,
                                stable_max_grad=stable_max_grad)
    if backbone == "dgcnn":
        return DGCNNBackbone(in_features, layer_sizes, approx_knn=approx_knn,
                             knn_impl=knn_impl, fused_train=fused_train,
                             stable_max_grad=stable_max_grad)
    raise ValueError(f"unknown backbone {backbone!r}")
