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
from alignnet3d_tpu_torch.ops.knn import gather_rows, knn, pairwise_distance
from alignnet3d_tpu_torch.ops.knn_kernels import knn_points


class PointNetBackbone(nn.Module):
    """dense -> BN -> relu per point for each width, then the channel-wise
    max over the N points: (B, N, C) -> (B, layer_sizes[-1])."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int]):
        super().__init__()
        self.num_layers = len(layer_sizes)
        widths = (in_features, *layer_sizes)
        for i in range(self.num_layers):
            self.add_module(f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            self.add_module(f"bn{i + 1}", EmaBatchNorm(widths[i + 1]))

    def forward(self, points: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        x = points.to(torch.float32)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x, momentum))
        # amax splits the gradient evenly across ties, as jnp.max does
        return torch.amax(x, dim=1)


class DGCNNBackbone(nn.Module):
    """Dynamic-graph edge-conv stack (reference ``_get_dgcnn``,
    tp8.py:30-46): kNN on the raw xyz (k=20), edge features
    ``[x_i, x_j - x_i]``, dense -> BN -> relu on the edges for all but the
    last width, max over the neighbours, a last dense -> BN -> relu per
    point, max over the points: (B, N, C) -> (B, layer_sizes[-1]).

    ``knn_impl='pallas'`` (the default, the JAX package's name) builds the
    graph with ``knn_points``, the CUDA kernel on the card; ``'xla'`` takes
    ``knn(pairwise_distance(x))``. Both give the same neighbours, ties to
    the lower index."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 k: int = 20, approx_knn: bool = False,
                 knn_impl: str = "pallas", fused_train: bool = False):
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
        if self.fused_train and self.training and self.num_layers == 3:
            raise NotImplementedError(
                "the fused DGCNN training stage (fused_edge_stage_train) is "
                "not ported yet (ROADMAP.md, Queue 2 item 5)")
        x = points.to(torch.float32)
        nn_idx = self.graph(x.detach())
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
        h = torch.amax(h, dim=2)  # max over the neighbours
        i = self.num_layers
        h = getattr(self, f"conv{i}")(h)
        h = torch.relu(getattr(self, f"bn{i}")(h, momentum))
        return torch.amax(h, dim=1)


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
        self.dropout = (nn.Dropout(p=1.0 - dropout_keep)
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
                  knn_impl: str = "pallas",
                  fused_train: bool = False) -> nn.Module:
    if backbone == "pointnet":
        return PointNetBackbone(in_features, layer_sizes)
    if backbone == "dgcnn":
        return DGCNNBackbone(in_features, layer_sizes, approx_knn=approx_knn,
                             knn_impl=knn_impl, fused_train=fused_train)
    raise ValueError(f"unknown backbone {backbone!r}")
