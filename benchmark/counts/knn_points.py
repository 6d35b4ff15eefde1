"""``knn_points``: each point's k nearest points of its own cloud.

count(batch, n, k): each point meets every point of its cloud (a 3-wide
dot product, 6 operations, and one compare for the top-k). Reads float32
xyz; writes k int64 indices a point.
"""

KERNELS = r"\bknn_points_kernel\b"


def count(batch: int, n: int, k: int) -> dict:
    pairs = batch * n * n
    return {"bytes": 12 * batch * n + 8 * batch * n * k,
            "dot_flops": 6 * pairs, "lane_ops": pairs}
