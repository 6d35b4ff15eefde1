"""knn_points' least time over its device time in the traced window."""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.roofline(reading, "knn_points")
