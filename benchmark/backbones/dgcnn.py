"""DGCNN (arXiv:1801.07829) as AlignNet's encoder backbone: a k=20 kNN
graph on the xyz, edge features [x_i, x_j - x_i] through the edge layers
and a max over the neighbours, a last per-point layer and a max over the
points.

Every forward builds the graph with ``knn_points``. Serving runs the two
edge layers as ``fused_edge_stage`` (the first layer's per-point halves U
and V are cuBLAS products outside it); a training step runs them forward
and backward as ``fused_edge_stage_train``.
"""

from __future__ import annotations

from benchmark.inputs.weights import chain

MODULE = "DGCNNBackbone_0"
XYZ = 3
IN_FEATURES = 2 * XYZ  # the edge feature [x_i, x_j - x_i]
K = 20


def layout(prefix: str, widths) -> list:
    """[(key, shape, kind)] of the leaves under ``prefix``."""
    return chain(prefix, (IN_FEATURES, *widths), "conv")


def flops(n: int, widths) -> tuple:
    """(dense, graph) dot FLOPs of one cloud of ``n`` points: the first
    edge layer as per-point halves (2 x 2 N 3 C1), the second over every
    edge (2 N k C1 C2) and the per-point last layer (2 N C2 C3); the
    graph's Gram products (2 N N 3)."""
    c1, c2, c3 = widths
    return (2 * 2 * n * XYZ * c1 + 2 * n * K * c1 * c2 + 2 * n * c2 * c3,
            2 * n * n * XYZ)


def kernel_calls(clouds: int, n: int, stacks, train: bool) -> dict:
    """{kernel: [count args]} of one forward (or training step) over
    ``clouds`` clouds, one backbone a width list of ``stacks``."""
    calls = {"knn_points": [(clouds, n, K)] * len(stacks)}
    if train:
        calls["fused_edge_stage_train"] = [(clouds, n, K, XYZ, s[0], s[1])
                                           for s in stacks]
    else:
        calls["fused_edge_stage"] = [(clouds, n, K, s[0], s[1])
                                     for s in stacks]
    return calls


def counters(train: bool) -> dict:
    """{kernel: the port's wrapper, whose ``.launches`` counts calls}."""
    from alignnet3d_tpu_torch.ops.knn_kernels import knn_points

    if train:
        from alignnet3d_tpu_torch.ops.edge_train_kernels import (
            fused_edge_stage_train)

        return {"knn_points": knn_points,
                "fused_edge_stage_train": fused_edge_stage_train}
    from alignnet3d_tpu_torch.ops.edge_conv_kernels import fused_edge_stage

    return {"knn_points": knn_points, "fused_edge_stage": fused_edge_stage}
