"""Serving-side input filter shared with training: voxel dedup.

The port's own copy of ``voxel_dedup_indices`` from
``alignnet3d_tpu/data/provider.py``, with the same semantics, so a model
trained on voxel-resampled clouds serves on the same quantisation.
"""

from __future__ import annotations

import numpy as np


def voxel_dedup_indices(points, cloud_ids, voxel_size: float):
    """Sorted indices of one representative point per (cloud, voxel): the
    first point of each, in input order."""
    pts = np.asarray(points, dtype=np.float32)
    keys = np.empty((len(pts), 4), dtype=np.int64)
    keys[:, 0] = cloud_ids
    keys[:, 1:] = np.floor(pts[:, :3] / float(voxel_size)).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    first.sort()
    return first
