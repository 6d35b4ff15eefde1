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
Only its numpy path is ported: the native C++ assembler
(``native/loader.cpp``), the component filter and the voxel resampling
view raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import threading
import time

import numpy as np

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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: the native loader "
        "binding and data.denoise/data.resample)")


class PackedDataset:
    """A dataset packed into flat ragged arrays for fast batching."""

    def __init__(self, basepath: str, indices=None, cache: bool = True,
                 mmap: bool = True):
        self.basepath = basepath
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

    def enable_component_filter(self, *args, **kwargs):
        raise _not_ported("PackedDataset.enable_component_filter")

    def enable_voxel_resample(self, *args, **kwargs):
        raise _not_ported("PackedDataset.enable_voxel_resample")

    def rows(self, file_indices):
        """Dataset file indices -> packed row numbers."""
        return np.asarray(
            [self.index_map[int(i)] for i in np.asarray(file_indices).ravel()],
            dtype=np.int64)

    def metas(self, file_indices):
        return [json.loads(self.metas_json[r]) for r in self.rows(file_indices)]

    def sample_batch(self, file_indices, num_points: int,
                     rng: np.random.Generator, use_native: bool = False):
        """(pcs1, pcs2, translations, rel_angles, pc1centers, pc2centers,
        pc1angles, pc2angles): each cloud resampled with replacement to
        ``num_points`` (empty clouds become zeros, reference
        provider.py:95-98), the labels as float64. The numpy path of the
        JAX package's ``sample_batch(..., use_native=False)``, with the
        same draws from ``rng``."""
        if use_native:
            raise _not_ported("the native batch assembler (use_native)")
        rows = self.rows(file_indices)
        b = len(rows)
        out = []
        for k in (1, 2):
            counts = getattr(self, f"counts{k}")[rows]
            offsets = getattr(self, f"offsets{k}")[rows]
            safe_counts = np.maximum(counts, 1)
            pick = (rng.random((b, num_points))
                    * safe_counts[:, None]).astype(np.int64)
            pts = getattr(self, f"points{k}")[offsets[:, None] + pick]
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
