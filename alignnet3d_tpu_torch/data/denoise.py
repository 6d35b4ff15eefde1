"""Clutter rejection: grid-connectivity component filter.

The port's own copy of ``alignnet3d_tpu/data/denoise.py``, with the same
semantics, so a model trained on filtered clouds serves on the same
filter. Points are hashed to a cubic grid at ``cell`` resolution; occupied
cells that touch in the 26-neighbourhood are unioned; each point belongs
to its cell's component (single-linkage clustering at grid resolution).
One component is kept:

  keep='largest'  the one with most points;
  keep='central'  the one whose centroid is nearest the coordinate-wise
                  median of the whole cloud.
"""

from __future__ import annotations

import numpy as np

# half of the 26-neighbourhood: lexicographically positive offsets, so each
# adjacent cell pair is unioned once
_HALF_OFFSETS = np.array(
    [(a - 1, b - 1, c - 1) for a, b, c in np.ndindex(3, 3, 3)
     if (a - 1, b - 1, c - 1) > (0, 0, 0)],
    dtype=np.int64,
)


def _find(parent: np.ndarray, i: int) -> int:
    root = i
    while parent[root] != root:
        root = parent[root]
    while parent[i] != root:  # path compression
        parent[i], i = root, parent[i]
    return root


def grid_component_labels(points: np.ndarray, cell: float) -> np.ndarray:
    """Per-point component labels (int64 root ids) under grid
    connectivity at ``cell``."""
    pts = np.asarray(points, dtype=np.float64)
    cells = np.floor(pts[:, :3] / float(cell)).astype(np.int64)
    uniq, inv = np.unique(cells, axis=0, return_inverse=True)
    n = len(uniq)
    lut = {tuple(c): i for i, c in enumerate(uniq)}
    parent = np.arange(n, dtype=np.int64)
    for i, c in enumerate(uniq):
        for off in _HALF_OFFSETS:
            j = lut.get((c[0] + off[0], c[1] + off[1], c[2] + off[2]))
            if j is not None:
                ri, rj = _find(parent, i), _find(parent, j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([_find(parent, i) for i in range(n)], dtype=np.int64)
    return roots[inv]


def component_keep_mask(points: np.ndarray, cell: float = 0.5,
                        keep: str = "central") -> np.ndarray:
    """Boolean mask of the kept component's points; all True for an empty
    or single-component cloud."""
    if keep not in ("largest", "central"):
        raise ValueError(f"keep must be 'largest' or 'central', got {keep!r}")
    pts = np.asarray(points, dtype=np.float64)
    m = len(pts)
    if m == 0:
        return np.ones(0, dtype=bool)
    labels = grid_component_labels(pts, cell)
    uniq, inv, counts = np.unique(labels, return_inverse=True,
                                  return_counts=True)
    if len(uniq) == 1:
        return np.ones(m, dtype=bool)
    if keep == "largest":
        target = int(np.argmax(counts))
    else:
        med = np.median(pts[:, :3], axis=0)
        cent = np.zeros((len(uniq), 3))
        np.add.at(cent, inv, pts[:, :3])
        cent /= counts[:, None]
        target = int(np.argmin(np.linalg.norm(cent - med, axis=1)))
    return inv == target


def component_filter_indices(points: np.ndarray, cloud_ids: np.ndarray,
                             cell: float, keep: str) -> np.ndarray:
    """Sorted indices of the kept points of a concatenated block of clouds
    (runs of equal ``cloud_ids``), as ``voxel_dedup_indices`` takes them."""
    pts = np.asarray(points, dtype=np.float32)
    ids = np.asarray(cloud_ids)
    out = []
    start = 0
    while start < len(ids):
        end = start
        while end < len(ids) and ids[end] == ids[start]:
            end += 1
        mask = component_keep_mask(pts[start:end], cell, keep)
        out.append(np.nonzero(mask)[0].astype(np.int64) + start)
        start = end
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out)
