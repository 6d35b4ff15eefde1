"""``nn_argmin``: each source point's nearest valid destination point.

count(batch, n_src, n_dst, valid_dst): ``valid_dst`` is the number of
valid destination points summed over the batch. Each source point meets
each valid destination point of its pair: a 3-wide dot product (6
operations) and one compare. Reads src, dst (float32 xyz) and the mask;
writes an int64 index and a float32 squared distance a source point.
"""

KERNELS = r"\bnn_(table|sweep|merge)_kernel\b"


def count(batch: int, n_src: int, n_dst: int, valid_dst: int) -> dict:
    pairs = n_src * valid_dst
    return {"bytes": 12 * batch * (n_src + n_dst) + batch * n_dst
            + 12 * batch * n_src,
            "dot_flops": 6 * pairs, "lane_ops": pairs}
