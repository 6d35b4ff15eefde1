"""Model and nearest-neighbour dot FLOPs of the traced tracker requests
over the window, against the TF32 peak.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.mfu(reading)
