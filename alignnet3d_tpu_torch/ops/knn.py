"""Dynamic-graph ops: pairwise distances, k-NN, edge features.

Counterpart of ``alignnet3d_tpu/ops/knn.py`` (reference
utils/tf_util_dgcnn.py:638-706). These are the plain building blocks of
the DGCNN graph; the fused kernel ``ops.knn_kernels.knn_points`` gives the
same neighbours from raw points.
"""

from __future__ import annotations

import torch


def pairwise_distance(points: torch.Tensor) -> torch.Tensor:
    """Negative squared pairwise distances (B, N, N): LARGER means closer,
    the reference's sign convention."""
    inner = torch.einsum("bnd,bmd->bnm", points, points)
    sq = torch.sum(torch.square(points), dim=-1)
    return 2.0 * inner - sq[:, :, None] - sq[:, None, :]


def knn(neg_dist: torch.Tensor, k: int = 20,
        approximate: bool = False) -> torch.Tensor:
    """Indices (B, N, k) int64 of the k largest entries of each row, in
    descending order with ties to the lower index, as ``lax.top_k``
    orders them (``torch.topk`` promises no order among ties)."""
    if approximate:
        raise NotImplementedError(
            "approximate kNN (lax.approx_max_k) is a TPU primitive and is "
            "not ported; use the exact graph")
    order = torch.sort(neg_dist, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def gather_rows(values: torch.Tensor, nn_idx: torch.Tensor) -> torch.Tensor:
    """Neighbour row lookup: (B, N, C) x (B, N, k) -> (B, N, k, C)."""
    b, n, c = values.shape
    kk = nn_idx.shape[-1]
    offsets = (torch.arange(b, dtype=nn_idx.dtype, device=nn_idx.device)
               * n)[:, None, None]
    flat_idx = (nn_idx + offsets).reshape(-1)
    return values.reshape(b * n, c).index_select(0, flat_idx).reshape(
        b, n, kk, c)


def get_edge_feature(points: torch.Tensor, nn_idx: torch.Tensor,
                     k: int = 20) -> torch.Tensor:
    """Edge features ``[x_i, x_j - x_i]``, shape (B, N, k, 2C); ``k`` is
    implied by ``nn_idx``."""
    del k
    neighbors = gather_rows(points, nn_idx)
    central = points[:, :, None, :]
    return torch.cat([central.expand_as(neighbors), neighbors - central],
                     dim=-1)
