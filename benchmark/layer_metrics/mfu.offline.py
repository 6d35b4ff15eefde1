"""Model dot FLOPs of the traced offline requests over the window,
against the TF32 peak.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.mfu(reading)
