"""``fused_pointnet``: a dense -> relu chain per point and the max over
the points.

count(clouds, points, widths): widths = (3, c1, ..., cL). Dot FLOPs 2 *
points * sum(c_in * c_out) a cloud; one relu a layer output element and one
max an element of the last layer. Reads the points, weights and biases;
writes (clouds, cL) float32.
"""

KERNELS = r"\bfused_pointnet_kernel\b"


def count(clouds: int, points: int, widths) -> dict:
    pairs = list(zip(widths[:-1], widths[1:]))
    rows = clouds * points
    params = sum(a * b + b for a, b in pairs)
    return {"bytes": 4 * (rows * widths[0] + params + clouds * widths[-1]),
            "dot_flops": 2 * rows * sum(a * b for a, b in pairs),
            "lane_ops": rows * (sum(b for _, b in pairs) + widths[-1])}
