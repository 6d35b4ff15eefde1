"""Dot-product FLOPs of the AlignNet model, and the kernel calls its
forward makes, from a config's ``model`` section.

A cloud runs three backbones (transformer1, transformer2, the embedding)
and two heads; a pair adds the remaining head on both embeddings. PointNet
backbone: 2 N sum(c_in c_out). DGCNN backbone: the kNN graph's Gram
products (2 N N 3), the first edge layer as per-point halves (2 x 2 N 3
C1), the second over every edge (2 N k C1 C2) and the per-point last layer
(2 N C2 C3). A training step counts 3 x the forward (forward, input and
weight gradients) but the graph once.
"""

K = 20


def _backbone(kind, n, widths):
    if kind == "pointnet":
        return 2 * n * sum(a * b for a, b in zip(widths[:-1], widths[1:])), 0
    c_in, c1, c2, c3 = widths
    graph = 2 * n * n * c_in
    return 2 * 2 * n * c_in * c1 + 2 * n * K * c1 * c2 + 2 * n * c2 * c3, graph


def _head(widths):
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def flops(model: dict, pairs: int, train: bool = False) -> float:
    opts = model["options"]
    n, kind = model["num_points"], model["backbone"]
    bins = model["angles"]["num_bins"]
    dense, graph = 0, 0
    for sizes, head_out in ((opts["s1transformer"], 3),
                            (opts["s2transformer"], 3 + 2 * bins)):
        d, g = _backbone(kind, n, (3, *sizes[0]))
        dense += d + _head((sizes[0][-1], *sizes[1][0], head_out))
        graph += g
    d, g = _backbone(kind, n, (3, *opts["embedding"]))
    dense, graph = 2 * (dense + d), 2 * (graph + g)  # two clouds a pair
    rem = opts["remaining_transform_prediction"][0]
    dense += _head((2 * opts["embedding"][-1], *rem, 3 + 2 * bins))
    return pairs * ((3 if train else 1) * dense + graph)


def kernel_calls(model: dict, batch_pairs: int, train: bool = False) -> dict:
    """{kernel: [shape args of count()]} of one forward (or training step)
    at ``batch_pairs`` pairs: both clouds run stacked, 2 x batch_pairs."""
    opts = model["options"]
    clouds, n = 2 * batch_pairs, model["num_points"]
    stacks = [opts["s1transformer"][0], opts["s2transformer"][0],
              opts["embedding"]]
    if model["backbone"] == "pointnet":
        return {"fused_pointnet": [(clouds, n, (3, *s)) for s in stacks]}
    calls = {"knn_points": [(clouds, n, K)] * 3}
    if train:
        calls["fused_edge_stage_train"] = [(clouds, n, K, 3, s[0], s[1])
                                           for s in stacks]
    else:
        calls["fused_edge_stage"] = [(clouds, n, K, s[0], s[1])
                                     for s in stacks]
    return calls
