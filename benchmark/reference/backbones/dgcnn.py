"""Plain PyTorch DGCNN backbone (arXiv:1801.07829; AlignNet's tp8.py
``_get_dgcnn``): a kNN graph on the xyz (k=20, each point among its own
neighbours), edge features [x_i, x_j - x_i] through every layer but the
last with a max over the neighbours, the last layer per point, then the
max over the points. The edge features are formed and multiplied as they
stand (the program splits the first layer into per-point products)."""

from __future__ import annotations

import torch

from benchmark.reference.model import batch_norm, dense, sq_distances

K_NEIGHBOURS = 20


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, k) indices of each point's k nearest points of its cloud
    (itself among them), ties to the lower index."""
    return torch.sort(sq_distances(x, x), dim=-1, stable=True).indices[..., :k]


def _gather_rows(x, idx):
    b, n, c = x.shape
    flat = (idx + (torch.arange(b, device=x.device) * n)[:, None, None])
    return x.reshape(b * n, c)[flat.reshape(-1)].reshape(*idx.shape, c)


def forward(x, sd, prefix, n_layers, train):
    """(B, N, 3) -> (B, C_last) over the leaves ``<prefix>.conv<i>`` and
    ``<prefix>.bn<i>`` of ``sd``."""
    idx = knn_graph(x.detach(), min(K_NEIGHBOURS, x.shape[1]))
    nbr = _gather_rows(x, idx)
    centre = x[:, :, None, :].expand_as(nbr)
    h = torch.cat([centre, nbr - centre], dim=-1)
    for i in range(1, n_layers):
        h = torch.relu(batch_norm(dense(h, sd, f"{prefix}.conv{i}"), sd,
                                  f"{prefix}.bn{i}", train))
    h = h.amax(2)
    h = torch.relu(batch_norm(dense(h, sd, f"{prefix}.conv{n_layers}"), sd,
                              f"{prefix}.bn{n_layers}", train))
    return h.amax(1)
