"""fused_edge_stage's least time over its device time in the traced window
(the U/V products are cuBLAS launches of their own, outside it).
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.roofline(reading, "fused_edge_stage")
