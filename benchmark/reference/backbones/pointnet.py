"""Plain PyTorch PointNet backbone (arXiv:1612.00593; AlignNet's tp8.py
shared MLP): dense -> batch norm -> relu per point for each width, then
the max over the points."""

from __future__ import annotations

import torch

from benchmark.reference.model import batch_norm, dense


def forward(x, sd, prefix, n_layers, train):
    """(B, N, 3) -> (B, C_last) over the leaves ``<prefix>.conv<i>`` and
    ``<prefix>.bn<i>`` of ``sd``."""
    for i in range(1, n_layers + 1):
        x = torch.relu(batch_norm(dense(x, sd, f"{prefix}.conv{i}"), sd,
                                  f"{prefix}.bn{i}", train))
    return x.amax(1)
