"""Point-cloud encoder backbones: the PointNet branch.

Counterpart of ``alignnet3d_tpu/models/backbones.py``. The reference's
per-point "shared MLP" (models/tp8.py:49-59) is a stack of dense layers
over the channel axis followed by a max over the points. Submodule names
(``conv{i}``, ``bn{i}``, ``fc{i}``) are the flax names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from alignnet3d_tpu_torch.models.batchnorm import EmaBatchNorm


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
                  layer_sizes: Sequence[int]) -> nn.Module:
    if backbone == "pointnet":
        return PointNetBackbone(in_features, layer_sizes)
    if backbone == "dgcnn":
        raise NotImplementedError(
            "the DGCNN backbone is not ported yet (ROADMAP.md, Queue 1: "
            "DGCNN branch)")
    raise ValueError(f"unknown backbone {backbone!r}")
