"""``fused_edge_stage`` (serving): given the first layer's per-point halves
U and V (B, N, C1), each edge (i, j) of the kNN graph takes relu(U_i +
V_j), the second dense layer (C1 -> C2) and a relu, and the max over the
k edges of a point.

count(batch, n, k, c1, c2): dot FLOPs 2 * B N k C1 C2 (42.9 G at 256 x 512
x 20 x 64 x 128); lane operations B N k (C1 + 2 C2) (the relu of each
layer and the max). Reads U, V, the int64 graph, W2 and b2; writes (B, N,
C2) float32. The U/V products are cuBLAS launches of their own and are not
in this count.
"""

KERNELS = r"\bedge_stage_kernel\b"


def count(batch: int, n: int, k: int, c1: int, c2: int) -> dict:
    edges = batch * n * k
    return {"bytes": 4 * (2 * batch * n * c1 + c1 * c2 + c2
                          + batch * n * c2) + 8 * edges,
            "dot_flops": 2 * edges * c1 * c2,
            "lane_ops": edges * (c1 + 2 * c2)}
