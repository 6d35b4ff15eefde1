"""Host time a tracker request spends in ICP (upload, the iterations'
dispatch, the fitness pass and the readback that waits for the card): the
``icp.run`` span's total time per request.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.ms_per("icp.run", "total_s", "api.align")
