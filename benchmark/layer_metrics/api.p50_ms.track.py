"""Median wall time of the measured window's tracker requests, from the
benchmark's span around Aligner.align.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.median_ms(reading.get("latencies_s"))
