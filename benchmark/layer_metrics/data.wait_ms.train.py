"""Mean host time a step waits in next() on the PrefetchIterator in the
measured window.
"""

from benchmark.layer_metrics import _common


def read(reading):
    return _common.mean_ms(reading.get("wait_s"))
