"""Share of the traced training window with no operation on the card."""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.idle_pct(reading)
