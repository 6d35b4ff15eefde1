"""Published peaks of one NVIDIA H100 SXM (dense, 700 W), and the least
time a counted piece of work can take on it.

A dot product is held to the TF32 tensor-core peak: the fastest route that
keeps float32 accuracy (3xTF32, or bfloat16 splits) cannot beat it, so no
implementation of these float32 functions reads over 100%. Lane-only work
(compares, selects, relu, max) is held to the FP32 lane rate.
"""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12       # dense TF32 tensor cores
LANE_OPS_PER_S = 33.5e12  # FP32 lane instructions (67 TFLOP/s of FMA)


def least_seconds(work: dict) -> float:
    """The largest of bytes / HBM rate, dot FLOPs / TF32 peak and lane
    operations / lane rate."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["dot_flops"] / TF32_FLOPS,
               work["lane_ops"] / LANE_OPS_PER_S)


def add(works) -> dict:
    total = {"bytes": 0.0, "dot_flops": 0.0, "lane_ops": 0.0}
    for w in works:
        for k in total:
            total[k] += w[k]
    return total
