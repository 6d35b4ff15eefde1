"""The seeded inputs of a run, cached in the checkout.

Serving cells draw their requests from a pool of full-resolution scene
pairs; the training cell packs a dataset from lower-resolution scenes.
Both come from ``scenes.make_scenes`` in worker processes. A pool is kept
under ``benchmark/.cache/`` keyed by the run seed, the stream, the count,
the scan resolution and ``GENERATOR_VERSION``; only the newest
``KEEP_FILES`` files stay, so the cache holds a few seeds (about 90 MB
each at 256 full-resolution pairs).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from benchmark.inputs import scenes

CACHE_DIR = Path(__file__).resolve().parents[1] / ".cache"
KEEP_FILES = 4
LABEL_KEYS = ("translation", "rel_angle", "start_position", "end_position",
              "start_angle", "end_angle")


def _pack(items):
    out = {}
    for k in (0, 1):
        clouds = [it[k] for it in items]
        out[f"points{k + 1}"] = np.concatenate(clouds)
        out[f"counts{k + 1}"] = np.asarray([len(c) for c in clouds], np.int64)
    for key in LABEL_KEYS:
        out[key] = np.asarray([np.asarray(it[2][key], np.float64)
                               for it in items])
    out["scene_seeds"] = np.asarray([it[2]["seed"] for it in items], np.int64)
    out["mesh_ids"] = np.asarray([it[2]["mesh_id"] for it in items], np.int64)
    return out


def _unpack(arrays):
    items = []
    offs = {k: np.concatenate([[0], np.cumsum(arrays[f"counts{k}"])])
            for k in (1, 2)}
    for i in range(len(arrays["counts1"])):
        clouds = [arrays[f"points{k}"][offs[k][i]:offs[k][i + 1]]
                  for k in (1, 2)]
        lab = {key: arrays[key][i] for key in LABEL_KEYS}
        lab["rel_angle"] = float(lab["rel_angle"])
        lab["start_angle"] = float(lab["start_angle"])
        lab["end_angle"] = float(lab["end_angle"])
        lab["seed"] = int(arrays["scene_seeds"][i])
        lab["mesh_id"] = int(arrays["mesh_ids"][i])
        items.append((clouds[0], clouds[1], lab))
    return items


def load_or_make(seed: int, stream: int, count: int, rays, workers: int,
                 cache: bool = True):
    """[(cloud1, cloud2, labels)] * count for the run seed; read from the
    cache when present, else generated (and cached when ``cache``)."""
    vres, hres = rays
    name = (f"pool-{scenes.GENERATOR_VERSION}-{int(seed)}-{stream}-{count}"
            f"-{vres}x{hres}.npz")
    path = CACHE_DIR / name
    if cache and path.exists():
        with np.load(path) as z:
            return _unpack({k: z[k] for k in z.files})
    items = scenes.make_scenes(seed, stream, count, vres, hres, workers)
    if cache:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, **_pack(items))
        os.replace(tmp, path)
        kept = sorted(CACHE_DIR.glob("pool-*.npz"),
                      key=lambda p: p.stat().st_mtime, reverse=True)
        for old in kept[KEEP_FILES:]:
            old.unlink(missing_ok=True)
    return items
