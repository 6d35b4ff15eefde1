"""Share of a tracker request's ICP iterations whose pose update ran as one
kernel launch (``icp_update``): 100 x the ``icp.fused_steps`` counter over
``icp.steps``. A program that counts neither reads as nothing.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.percent("icp.fused_steps", "icp.steps")
