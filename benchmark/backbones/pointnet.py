"""PointNet (arXiv:1612.00593) as AlignNet's encoder backbone: dense ->
batch norm -> relu per point for each width, then the max over the points.

Serving runs each BN-folded chain as one ``fused_pointnet`` launch.
Training runs ``nn.Linear`` and batch norm eagerly and launches no
hand-written kernel.
"""

from __future__ import annotations

from benchmark.inputs.weights import chain

MODULE = "PointNetBackbone_0"
IN_FEATURES = 3  # xyz


def layout(prefix: str, widths) -> list:
    """[(key, shape, kind)] of the leaves under ``prefix``."""
    return chain(prefix, (IN_FEATURES, *widths), "conv")


def flops(n: int, widths) -> tuple:
    """(dense, graph) dot FLOPs of one cloud of ``n`` points: 2 N sum(c_in
    c_out); no graph."""
    w = (IN_FEATURES, *widths)
    return 2 * n * sum(a * b for a, b in zip(w[:-1], w[1:])), 0


def kernel_calls(clouds: int, n: int, stacks, train: bool) -> dict:
    """{kernel: [count args]} of one forward over ``clouds`` clouds, one
    backbone a width list of ``stacks``; a training step launches none."""
    if train:
        return {}
    return {"fused_pointnet": [(clouds, n, (IN_FEATURES, *s))
                               for s in stacks]}


def counters(train: bool) -> dict:
    """{kernel: the port's wrapper, whose ``.launches`` counts calls}."""
    if train:
        return {}
    from alignnet3d_tpu_torch.ops.pointnet_kernels import fused_pointnet

    return {"fused_pointnet": fused_pointnet}
