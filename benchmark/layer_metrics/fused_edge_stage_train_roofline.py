"""fused_edge_stage_train's least time over its device time (10 launches
a call) in the traced window.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.roofline(reading, "fused_edge_stage_train")
