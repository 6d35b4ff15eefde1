"""Data provider: the reference's on-disk dataset format and a packed fast
path for batching.

The port's own copy of ``alignnet3d_tpu/data/provider.py``, with the same
semantics, the same cache files and the same numpy RNG calls, so a batch
drawn from one generator is bit-equal in both packages:

    <basepath>/meta/%08d.json         translation/rel_angle/start+end pose
    <basepath>/pointcloud1/%08d.npy   (Ni, 3+) float points
    <basepath>/pointcloud2/%08d.npy
    <basepath>/split/{train,val}.txt  integer indices

``PackedDataset`` packs a dataset into flat ragged arrays once, cached next
to it as ``packed_v2.npz`` + ``packed_v2_points{1,2}.npy`` (memory-mapped),
after which ``sample_batch`` resamples each cloud with replacement to
``num_points`` (reference provider.py:97-98) with a few vectorised gathers.
Two views rewrite what it draws from: the component filter
(data.denoise) and the voxel resampling view (data.resample), cached
under the JAX package's names. By default the batch is assembled by the
port's native C++ assembler (``data/native_loader.py``, a copy of
``native/loader.cpp``), as in the JAX package, and by numpy when its
library is unavailable.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import threading
import time

import numpy as np

from alignnet3d_tpu_torch.data import native_loader
from alignnet3d_tpu_torch.data.denoise import component_filter_indices
from alignnet3d_tpu_torch.geometry import str_to_np

logger = logging.getLogger("alignnet3d_tpu_torch")

PACK_VERSION = 2
_LABELS = ("translations", "rel_angles", "pc1centers", "pc2centers",
           "pc1angles", "pc2angles")


def getDataFiles(list_filename: str):
    """Read split indices (reference provider.py:74-75)."""
    with open(list_filename) as f:
        return [int(line.rstrip()) for line in f if line.strip()]


def load_meta(basepath: str, idx: int) -> dict:
    with open(f"{basepath}/meta/{str(idx).zfill(8)}.json") as f:
        return json.load(f)


def parse_meta_labels(meta: dict):
    """The 6 labels of a meta dict (reference provider.py:86-89)."""
    translation = str_to_np(meta["translation"])
    rel_angle = meta["rel_angle"]
    pc1center = str_to_np(meta["start_position"])
    pc2center = str_to_np(meta["end_position"])
    pc1angle = meta["start_angle"]
    pc2angle = meta["end_angle"]
    return translation, rel_angle, pc1center, pc2center, pc1angle, pc2angle


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


class PackedDataset:
    """A dataset packed into flat ragged arrays for fast batching."""

    def __init__(self, basepath: str, indices=None, cache: bool = True,
                 mmap: bool = True):
        self.basepath = basepath
        self._vox = None  # (points, offsets, counts) per side, voxel view
        all_indices = self._discover_indices(basepath)
        meta_file = os.path.join(basepath, f"packed_v{PACK_VERSION}.npz")
        point_files = {
            k: os.path.join(basepath, f"packed_v{PACK_VERSION}_points{k}.npy")
            for k in (1, 2)
        }
        v1_file = os.path.join(basepath, "packed_v1.npz")
        if cache:
            self._load_or_build_cache(basepath, all_indices, meta_file,
                                      point_files, v1_file, mmap)
        else:
            self._init_from_arrays(self._pack(basepath, all_indices))
        self.index_map = {int(v): i for i, v in enumerate(self.indices)}
        if indices is not None:
            missing = [i for i in indices if int(i) not in self.index_map]
            if missing:
                raise ValueError(
                    f"indices missing from dataset: {missing[:10]}")

    # ------------------------------------------------------------ cache IO

    @staticmethod
    def _cache_complete(meta_file, point_files):
        return os.path.isfile(meta_file) and all(
            os.path.isfile(p) for p in point_files.values())

    def _load_cache(self, meta_file, point_files, mmap):
        data = np.load(meta_file)
        arrays = {k: data[k] for k in data.files}
        for k in (1, 2):
            arrays[f"points{k}"] = np.load(
                point_files[k], mmap_mode="r" if mmap else None)
        self._init_from_arrays(arrays)

    @staticmethod
    def _lock_stale(lock_file, max_age_s=6 * 3600):
        """A pack lock is stale when its owner pid is dead or it is older
        than any plausible pack."""
        try:
            pid_txt = open(lock_file).read().strip()
            if pid_txt:
                os.kill(int(pid_txt), 0)  # raises if the owner is gone
            elif time.time() - os.path.getmtime(lock_file) < 10.0:
                return False  # the owner may still be writing its pid
            else:
                return True
            return time.time() - os.path.getmtime(lock_file) > max_age_s
        except (OSError, ValueError):
            return True

    def _load_or_build_cache(self, basepath, all_indices, meta_file,
                             point_files, v1_file, mmap,
                             wait_timeout_s=2 * 3600):
        """Load the packed cache; when it is missing, exactly one process
        (the holder of an O_EXCL lock file) packs it and the others wait
        for the meta npz, written last, as the commit marker."""
        lock_file = meta_file + ".lock"
        deadline = time.time() + wait_timeout_s
        while True:
            if self._cache_complete(meta_file, point_files):
                self._load_cache(meta_file, point_files, mmap)
                return
            fd = None
            try:
                fd = os.open(lock_file, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
            except FileExistsError:
                if self._lock_stale(lock_file):
                    try:
                        os.remove(lock_file)
                    except OSError:
                        pass
                    continue
                if time.time() > deadline:
                    raise TimeoutError(
                        f"timed out waiting for packed cache {meta_file} "
                        f"(lock {lock_file} held by another process)")
                time.sleep(1.0)
                continue
            except OSError:
                fd = None  # unwritable dataset dir: pack without a lock
            try:
                if self._cache_complete(meta_file, point_files):
                    self._load_cache(meta_file, point_files, mmap)
                elif os.path.isfile(v1_file):
                    data = np.load(v1_file)
                    arrays = {k: data[k] for k in data.files}
                    self._init_from_arrays(arrays)
                    try:
                        self._write_cache(meta_file, point_files, arrays)
                        for k in (1, 2):
                            setattr(self, f"points{k}", np.load(
                                point_files[k],
                                mmap_mode="r" if mmap else None))
                    except OSError as e:
                        logger.warning(f"could not upgrade packed cache: {e}")
                else:
                    self._pack_streaming(basepath, all_indices, meta_file,
                                         point_files, mmap=mmap)
                return
            finally:
                if fd is not None:
                    os.close(fd)
                    try:
                        os.remove(lock_file)
                    except OSError:
                        pass

    @staticmethod
    def _savez_atomic(meta_file, small):
        """Write the meta npz (the commit marker) via a pid-unique temp file
        and a rename."""
        tmp = f"{meta_file}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **small)
        os.replace(tmp, meta_file)

    @classmethod
    def _write_cache(cls, meta_file, point_files, arrays):
        # points first, the meta npz last
        for k in (1, 2):
            pts = np.ascontiguousarray(
                np.asarray(arrays[f"points{k}"], np.float32))
            out = np.lib.format.open_memmap(
                point_files[k], mode="w+", dtype=np.float32, shape=pts.shape)
            out[:] = pts
            out.flush()
            del out
        cls._savez_atomic(meta_file, {k: v for k, v in arrays.items()
                                      if not k.startswith("points")})

    @staticmethod
    def _labels_of(meta, labels):
        t, ra, c1, c2, a1, a2 = parse_meta_labels(meta)
        labels["translations"].append(t)
        labels["rel_angles"].append([ra])
        labels["pc1centers"].append(c1)
        labels["pc2centers"].append(c2)
        labels["pc1angles"].append([a1])
        labels["pc2angles"].append([a2])

    def _pack_streaming(self, basepath, indices, meta_file, point_files,
                        mmap=True):
        """Two-pass pack straight into the on-disk cache: npy headers for
        the counts first, then the clouds into pre-allocated memmaps."""
        counts = {1: [], 2: []}
        for idx in indices:
            for k in (1, 2):
                hdr = np.load(
                    f"{basepath}/pointcloud{k}/{str(idx).zfill(8)}.npy",
                    mmap_mode="r")
                counts[k].append(hdr.shape[0])
        totals = {k: int(np.sum(counts[k], dtype=np.int64)) for k in (1, 2)}
        try:
            outs = {k: np.lib.format.open_memmap(
                point_files[k], mode="w+", dtype=np.float32,
                shape=(totals[k], 3)) for k in (1, 2)}
            spill = False
        except OSError as e:  # read-only dataset dir: pack in RAM
            logger.warning(f"could not cache packed dataset: {e}")
            outs = {k: np.empty((totals[k], 3), np.float32) for k in (1, 2)}
            spill = True
        labels = {name: [] for name in _LABELS}
        metas = []
        pos = {1: 0, 2: 0}
        for idx in indices:
            meta = load_meta(basepath, idx)
            metas.append(json.dumps(meta))
            self._labels_of(meta, labels)
            for k in (1, 2):
                pc = np.load(f"{basepath}/pointcloud{k}/{str(idx).zfill(8)}.npy")
                n = pc.shape[0]
                outs[k][pos[k]:pos[k] + n] = pc[:, :3]
                pos[k] += n
        arrays = {"indices": np.asarray(indices, dtype=np.int64),
                  "metas": np.asarray(metas)}
        for k in (1, 2):
            arrays[f"counts{k}"] = np.asarray(counts[k], dtype=np.int64)
            arrays[f"points{k}"] = outs[k]
        for name, vals in labels.items():
            arrays[name] = np.asarray(vals, dtype=np.float64)
        if not spill:
            for k in (1, 2):
                outs[k].flush()
            try:
                self._savez_atomic(meta_file, {
                    k: v for k, v in arrays.items()
                    if not k.startswith("points")})
            except OSError as e:
                logger.warning(f"could not cache packed dataset: {e}")
            if not mmap:
                for k in (1, 2):
                    arrays[f"points{k}"] = np.asarray(outs[k])
        self._init_from_arrays(arrays)

    @staticmethod
    def _discover_indices(basepath):
        metas = sorted(os.listdir(os.path.join(basepath, "meta")))
        return [int(m[:-5]) for m in metas if m.endswith(".json")]

    @classmethod
    def _pack(cls, basepath, indices):
        points = {1: [], 2: []}
        counts = {1: [], 2: []}
        labels = {name: [] for name in _LABELS}
        metas = []
        for idx in indices:
            meta = load_meta(basepath, idx)
            metas.append(json.dumps(meta))
            cls._labels_of(meta, labels)
            for k in (1, 2):
                pc = np.load(f"{basepath}/pointcloud{k}/{str(idx).zfill(8)}.npy")
                pc = np.asarray(pc[:, :3], dtype=np.float32)
                points[k].append(pc)
                counts[k].append(pc.shape[0])
        arrays = {"indices": np.asarray(indices, dtype=np.int64),
                  "metas": np.asarray(metas)}
        for k in (1, 2):
            arrays[f"points{k}"] = (np.concatenate(points[k], axis=0)
                                    if points[k]
                                    else np.zeros((0, 3), np.float32))
            arrays[f"counts{k}"] = np.asarray(counts[k], dtype=np.int64)
        for name, vals in labels.items():
            arrays[name] = np.asarray(vals, dtype=np.float64)
        return arrays

    def _init_from_arrays(self, arrays):
        self.indices = np.asarray(arrays["indices"], dtype=np.int64)
        self.metas_json = arrays["metas"]
        for k in (1, 2):
            setattr(self, f"points{k}", np.asarray(arrays[f"points{k}"]))
            counts = np.asarray(arrays[f"counts{k}"], dtype=np.int64)
            setattr(self, f"counts{k}", counts)
            offsets = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            setattr(self, f"offsets{k}", offsets)
        for name in _LABELS:
            setattr(self, name, np.asarray(arrays[name], dtype=np.float64))

    def __len__(self):
        return len(self.indices)

    # --------------------------------------------- component clutter filter

    def enable_component_filter(self, cell: float = 0.5,
                                keep: str = "central", cache: bool = True):
        """Clutter rejection view (``data/denoise.py``): each cloud is
        replaced by its kept grid-connectivity component, so every later
        consumer (uniform resample, voxel view, ICP) sees the filtered
        geometry. Cached as ``packed_v2_dn{k}_{cell}{keep[0]}``. Must come
        before ``enable_voxel_resample``, whose cache stem then carries the
        filter's tag."""
        if self._vox is not None:
            raise ValueError("enable_component_filter must come before the "
                             "voxel view")
        cell = float(cell)
        for k in (1, 2):
            counts = np.asarray(getattr(self, f"counts{k}"))
            offsets = np.asarray(getattr(self, f"offsets{k}"))
            pts = getattr(self, f"points{k}")
            stem = os.path.join(
                self.basepath,
                f"packed_v{PACK_VERSION}_dn{k}_{cell:g}{keep[0]}")
            pfile, mfile = f"{stem}_points.npy", f"{stem}_meta.npz"
            if cache and os.path.isfile(pfile) and os.path.isfile(mfile):
                meta = np.load(mfile)
                new_counts = meta["counts"]
                new_pts = np.load(pfile, mmap_mode="r")
                if (len(new_counts) == len(counts)
                        and int(meta["parent_total"]) == len(pts)
                        and int(new_counts.sum()) == len(new_pts)):
                    self._set_parent_arrays(k, new_pts, new_counts)
                    continue
            kept_all = []
            new_counts = np.zeros(len(counts), dtype=np.int64)
            for start, end in self._cloud_blocks(counts, 4_000_000):
                lo, hi = int(offsets[start]), int(offsets[end])
                if hi > lo:
                    block = np.asarray(pts[lo:hi], dtype=np.float32)
                    cid = np.repeat(np.arange(start, end, dtype=np.int64),
                                    counts[start:end])
                    kept = component_filter_indices(block, cid, cell, keep)
                    kept_all.append(kept + lo)
                    new_counts[start:end] = np.bincount(
                        cid[kept] - start, minlength=end - start)
            kept_idx = (np.concatenate(kept_all) if kept_all
                        else np.zeros(0, dtype=np.int64))
            new_pts = (np.asarray(pts, dtype=np.float32)[kept_idx]
                       if len(kept_idx) else np.zeros((0, 3), np.float32))
            if cache:
                try:
                    tmp = f"{pfile}.tmp.{os.getpid()}.npy"
                    np.save(tmp[:-4], new_pts)
                    os.replace(tmp, pfile)
                    self._savez_atomic(mfile, {
                        "counts": new_counts,
                        "parent_total": np.int64(len(pts))})
                except OSError:
                    pass  # read-only dir: the filtered view stays in RAM
            self._set_parent_arrays(k, new_pts, new_counts)
        self._denoise_tag = f"dn{cell:g}{keep[0]}"

    @staticmethod
    def _cloud_blocks(counts, chunk_points: int):
        """(start, end) runs of whole clouds of at most ``chunk_points``
        points each (one cloud alone may exceed it)."""
        start, n_clouds = 0, len(counts)
        while start < n_clouds:
            end, npts = start, 0
            while end < n_clouds and (npts == 0
                                      or npts + counts[end] <= chunk_points):
                npts += int(counts[end])
                end += 1
            yield start, end
            start = end

    def _set_parent_arrays(self, k: int, pts, counts):
        offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        setattr(self, f"points{k}", pts)
        setattr(self, f"counts{k}", np.asarray(counts, dtype=np.int64))
        setattr(self, f"offsets{k}", offsets)

    # ------------------------------------------------- voxel resample view

    def enable_voxel_resample(self, voxel_size: float, cache: bool = True):
        """Density-equalised resampling (the reference only resamples
        uniformly with replacement, provider.py:97-98): a one-point-per-voxel
        copy of each cloud is made once (cached next to the packed arrays)
        and ``sample_batch`` draws uniformly from it, about uniformly over
        the surface. A beam-model scan is quadratically denser on near
        surfaces, which a uniform draw over-weights."""
        views = {}
        for k in (1, 2):
            vpts, vcounts = self._voxel_view(k, float(voxel_size), cache)
            offsets = np.zeros(len(vcounts) + 1, dtype=np.int64)
            np.cumsum(vcounts, out=offsets[1:])
            views[k] = (vpts, offsets, vcounts)
        self._vox = views
        self._vox_size = float(voxel_size)

    def _vox_cache_files(self, k: int, voxel_size: float):
        # the component filter rewrites the parent arrays, so its voxel
        # view caches under a distinct stem
        dn = getattr(self, "_denoise_tag", None)
        suffix = f"_{dn}" if dn else ""
        stem = os.path.join(
            self.basepath,
            f"packed_v{PACK_VERSION}_vox{k}_{voxel_size:g}{suffix}")
        return f"{stem}_points.npy", f"{stem}_meta.npz"

    def _load_voxel_cache(self, k, points_file, meta_file):
        """A cached voxel view checked against the current parent arrays;
        None when stale (the dataset was rebuilt in place)."""
        meta = np.load(meta_file)
        counts = meta["counts"]
        vpts = np.load(points_file, mmap_mode="r")
        if (len(counts) == len(getattr(self, f"counts{k}"))
                and int(meta["parent_total"]) == len(
                    getattr(self, f"points{k}"))
                and int(counts.sum()) == len(vpts)):
            return vpts, counts
        return None

    def _voxel_view(self, k: int, voxel_size: float, cache: bool,
                    wait_timeout_s=2 * 3600):
        points_file, meta_file = self._vox_cache_files(k, voxel_size)
        if not cache:
            return self._build_voxel_view(k, voxel_size, points_file=None)
        # one builder, as for the packed cache: the meta npz is the commit
        # marker, the others wait for it
        lock_file = meta_file + ".lock"
        deadline = time.time() + wait_timeout_s
        while True:
            if os.path.isfile(meta_file) and os.path.isfile(points_file):
                loaded = self._load_voxel_cache(k, points_file, meta_file)
                if loaded is not None:
                    return loaded
            fd = None
            try:
                fd = os.open(lock_file, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
            except FileExistsError:
                if self._lock_stale(lock_file):
                    try:
                        os.remove(lock_file)
                    except OSError:
                        pass
                    continue
                if time.time() > deadline:
                    raise TimeoutError(
                        f"timed out waiting for voxel cache {meta_file}")
                time.sleep(1.0)
                continue
            except OSError:  # unwritable dir: build without caching
                return self._build_voxel_view(k, voxel_size,
                                              points_file=None)
            try:
                if os.path.isfile(meta_file) and os.path.isfile(points_file):
                    loaded = self._load_voxel_cache(k, points_file, meta_file)
                    if loaded is not None:
                        return loaded
                vpts, counts = self._build_voxel_view(
                    k, voxel_size, points_file=points_file)
                self._savez_atomic(meta_file, {
                    "counts": counts,
                    "parent_total": np.int64(len(getattr(self,
                                                         f"points{k}")))})
                return vpts, counts
            finally:
                os.close(fd)
                try:
                    os.remove(lock_file)
                except OSError:
                    pass

    def _build_voxel_view(self, k: int, voxel_size: float, points_file,
                          chunk_points: int = 4_000_000):
        """One representative point per occupied voxel of each cloud, in
        chunks of whole clouds. Written straight into a memmap at
        ``points_file`` (pid-unique temp file + rename) when given, else an
        array in RAM."""
        counts = np.asarray(getattr(self, f"counts{k}"))
        offsets = np.asarray(getattr(self, f"offsets{k}"))
        pts = getattr(self, f"points{k}")
        kept_parts = []
        vox_counts = np.zeros(len(counts), dtype=np.int64)
        for start, end in self._cloud_blocks(counts, chunk_points):
            lo, hi = int(offsets[start]), int(offsets[end])
            if hi > lo:
                block = np.asarray(pts[lo:hi], dtype=np.float32)
                cid = np.repeat(np.arange(start, end, dtype=np.int64),
                                counts[start:end])
                first = voxel_dedup_indices(block, cid, voxel_size)
                kept_parts.append(first.astype(np.int64) + lo)
                vox_counts[start:end] = np.bincount(cid[first] - start,
                                                    minlength=end - start)
        total = int(vox_counts.sum())
        if points_file is not None:
            tmp = f"{points_file}.tmp.{os.getpid()}.npy"
            out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                            shape=(total, 3))
        else:
            out = np.empty((total, 3), dtype=np.float32)
        pos = 0
        for kept in kept_parts:
            out[pos:pos + len(kept)] = pts[kept]
            pos += len(kept)
        if points_file is not None:
            out.flush()
            del out
            os.replace(tmp, points_file)
            out = np.load(points_file, mmap_mode="r")
        return out, vox_counts

    @staticmethod
    def shard_indices(indices, host_id: int, num_hosts: int):
        """Static per-process split of a set of file indices for
        multi-process data loading: process k takes every num_hosts-th
        index, and builds batches only from its own shard."""
        return list(indices)[host_id::num_hosts]

    def rows(self, file_indices):
        """Dataset file indices -> packed row numbers."""
        return np.asarray(
            [self.index_map[int(i)] for i in np.asarray(file_indices).ravel()],
            dtype=np.int64)

    def metas(self, file_indices):
        return [json.loads(self.metas_json[r]) for r in self.rows(file_indices)]

    def sample_batch(self, file_indices, num_points: int,
                     rng: np.random.Generator, use_native: bool = True):
        """(pcs1, pcs2, translations, rel_angles, pc1centers, pc2centers,
        pc1angles, pc2angles): each cloud resampled with replacement to
        ``num_points`` (empty clouds become zeros, reference
        provider.py:95-98), the labels as float64.

        The JAX package's ``sample_batch`` draw for draw: with
        ``use_native`` (the default) two seeds are drawn from ``rng`` and
        the native assembler resamples each view from one; when its library
        is unavailable the numpy path runs after those draws, as the JAX
        package falls back. The voxel view (enable_voxel_resample) has the
        uniform arrays' layout, so both paths apply to it unchanged."""
        rows = self.rows(file_indices)
        b = len(rows)
        views = {}
        for k in (1, 2):
            if self._vox is not None:
                views[k] = self._vox[k]
            else:
                views[k] = (getattr(self, f"points{k}"),
                            getattr(self, f"offsets{k}"),
                            getattr(self, f"counts{k}"))
        pcs = [None, None]
        if use_native:
            seeds = rng.integers(0, 2 ** 63, 2)
            # None when the library is unavailable (for both views alike)
            pcs = [native_loader.resample_gather(*views[k], rows, num_points,
                                                 int(seeds[k - 1]))
                   for k in (1, 2)]
        out = []
        for k, native_pc in zip((1, 2), pcs):
            if native_pc is not None:
                out.append(native_pc)
                continue
            points, offsets, counts = views[k]
            counts, offsets = counts[rows], offsets[rows]
            safe_counts = np.maximum(counts, 1)
            pick = (rng.random((b, num_points))
                    * safe_counts[:, None]).astype(np.int64)
            if self._vox is not None:
                if len(points) == 0:
                    out.append(np.zeros((b, num_points, 3), np.float32))
                    continue
                # an empty cloud gathers a clamped index and is zeroed below
                pts = np.asarray(points)[np.minimum(offsets[:, None] + pick,
                                                    len(points) - 1)]
            else:
                pts = points[offsets[:, None] + pick]
            pts = np.where(counts[:, None, None] > 0, pts, 0.0)
            out.append(np.ascontiguousarray(pts, dtype=np.float32))
        labels = [np.asarray(getattr(self, name)[rows]) for name in _LABELS]
        return (*out, *labels)


class PrefetchIterator:
    """Background-thread batch prefetcher: overlaps host batch assembly
    with the device's work (the reference loads synchronously,
    train.py:352)."""

    def __init__(self, make_batch, num_batches: int, prefetch: int = 2):
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, prefetch))
        self._num_batches = num_batches
        self._error = None

        def worker():
            try:
                for i in range(num_batches):
                    self._queue.put(make_batch(i))
            except BaseException as e:  # surfaced on next()
                self._error = e
            finally:
                self._queue.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __len__(self):
        return self._num_batches

    def __next__(self):
        item = self._queue.get()
        if item is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
