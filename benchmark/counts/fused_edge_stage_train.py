"""``fused_edge_stage_train``: forward and backward of the two edge layers
of a DGCNN backbone in train mode (batch-norm statistics over every edge),
with the max over the k edges of a point.

count(batch, n, k, c_in, c1, c2) of one forward + backward call: the
second layer's product over every edge three times (forward, the input
gradient and the weight gradient: batch norm's backward spreads the
gradient over all edges), 3 x 2 B N k C1 C2 = 128.7 G at 256 x 512 x 20 x
64 x 128, and the first layer's per-point halves three times, 3 x 2 x 2 B
N c_in C1; lane operations twice B N k (C1 + 2 C2). Reads x, the graph,
the parameters and the output gradient; writes the output, x's gradient
and the parameter gradients.
"""

LAUNCHES_PER_CALL = 10  # the port's counter counts kernel launches
KERNELS = (r"\(anonymous namespace\)::(channel_sums|fwd|select|bwd_mid"
           r"|bwd_in|reduce)_kernel\b")


def count(batch: int, n: int, k: int, c_in: int, c1: int, c2: int) -> dict:
    edges = batch * n * k
    params = 2 * c_in * c1 + c1 + c1 * c2 + c2 + 2 * (c1 + c2)
    return {"bytes": 4 * (2 * batch * n * c_in + 2 * batch * n * c2
                          + 2 * params) + 8 * edges,
            "dot_flops": 3 * (2 * edges * c1 * c2
                              + 2 * 2 * batch * n * c_in * c1),
            "lane_ops": 2 * edges * (c1 + 2 * c2)}
