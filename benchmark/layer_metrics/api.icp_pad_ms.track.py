"""Host time a tracker request spends padding its raw clouds for ICP
(subsampling those over 4,096 points) and stacking the inits: the
``api.icp_pad`` span's self time per request.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.ms_per("api.icp_pad", "self_s", "api.align")
