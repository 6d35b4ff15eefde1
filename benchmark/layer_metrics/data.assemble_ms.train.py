"""Host time the prefetch thread spends assembling one training batch
(``sample_batch``): the ``data.assemble`` span's total time per batch.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.ms_per("data.assemble", "total_s", "data.assemble")
