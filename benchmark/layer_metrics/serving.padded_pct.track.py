"""Share of the forward's rows that are padding: every chunk of a
request runs the full 128-row batch, whatever the pairs it holds
(counters ``serving.padded_rows`` over ``serving.rows``).
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.percent("serving.padded_rows", "serving.rows")
