"""The batch slices the port's per-cloud kernels are launched on.

Kernels 1-4 (``fused_pointnet``, ``nn_argmin``, ``knn_points``,
``fused_edge_stage``) carry the batch on a grid dimension of at most 65,535
blocks (``gridDim.y``/``z``), and their launchers refuse more. Each treats
every cloud on its own, so a wrapper launches its kernel on consecutive
slices of at most ``MAX_CLOUDS`` clouds, in order, into one output: the
result is that of one launch over the whole batch. The wrapper's launch
count still goes up by one a call.
"""

from __future__ import annotations

MAX_CLOUDS = 65535  # blocks a grid's y or z dimension may have


def batch_chunks(batch: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` ranges that cover ``[0, batch)`` in order, each
    of at most ``MAX_CLOUDS`` clouds."""
    return [(s, min(s + MAX_CLOUDS, batch))
            for s in range(0, batch, MAX_CLOUDS)]
