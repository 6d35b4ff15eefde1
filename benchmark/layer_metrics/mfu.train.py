"""Forward and backward model dot FLOPs of the traced steps over the
window, against the TF32 peak.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.mfu(reading)
