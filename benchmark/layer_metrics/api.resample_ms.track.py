"""Host time a tracker request spends resampling its clouds to the
model's points: the ``api.resample`` span's self time per request.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.ms_per("api.resample", "self_s", "api.align")
