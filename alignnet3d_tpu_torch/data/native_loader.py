"""ctypes binding of the port's batch assembler (``csrc/loader.cpp``).

The counterpart of ``alignnet3d_tpu/data/native_loader.py``: the same
three entry points (``get_lib``, ``resample_gather``, ``gather_labels``),
the same ABI-version check, and ``None`` from each when the library is
unavailable, so that ``PackedDataset.sample_batch`` falls back to its numpy
path as the JAX package does. The port builds and loads its own copy of the
source and never the JAX package's ``native/`` library.

The library is host code, built at first use by ``g++`` (never ``nvcc``):

    g++ -O3 -fPIC -shared -std=c++17 alignnet3d_tpu_torch/csrc/loader.cpp \
        -o build/loader/libalignnet3d_loader_<hash>.so

in the checkout's gitignored ``build/`` tree, under a name hashed from the
source and the flags, written to a temporary file and renamed into place,
so that concurrent processes never load a half-written library. No
``-march=native``: the library gives the same bits on every x86-64 host.

``resample_gather_plain`` is the same function in numpy (splitmix64 in
``np.uint64``), for the tests; the main path never calls it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger("alignnet3d_tpu_torch")

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loader"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ABI_VERSION = 1


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libalignnet3d_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; return its path. Raises
    ``OSError`` or ``subprocess.SubprocessError`` when it cannot."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def get_lib():
    """Load (building if needed) the library; None if unavailable."""
    try:
        path = build()
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug(f"native loader build failed: {e}")
        logger.info("native loader unavailable; using numpy path")
        return None
    lib = ctypes.CDLL(str(path))
    lib.loader_abi_version.restype = ctypes.c_int
    if lib.loader_abi_version() != ABI_VERSION:
        logger.warning("native loader ABI mismatch; using numpy path")
        return None
    lib.resample_gather.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # points_flat
        ctypes.POINTER(ctypes.c_int64),   # offsets
        ctypes.POINTER(ctypes.c_int64),   # counts
        ctypes.POINTER(ctypes.c_int64),   # rows
        ctypes.c_int64,                   # batch
        ctypes.c_int64,                   # num_points
        ctypes.c_uint64,                  # seed
        ctypes.POINTER(ctypes.c_float),   # out
    ]
    lib.resample_gather.restype = None
    lib.gather_labels.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.gather_labels.restype = None
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_rows(points_flat, offsets, counts, rows):
    """Refuse rows that would read outside the arrays."""
    if len(offsets) < len(counts):
        raise ValueError(f"{len(offsets)} offsets for {len(counts)} counts")
    if len(rows) == 0:
        return
    if rows.min() < 0 or rows.max() >= len(counts):
        raise ValueError(f"rows outside [0, {len(counts)})")
    c, o = counts[rows], offsets[rows]
    if ((c > 0) & ((o < 0) | (o + c > len(points_flat)))).any():
        raise ValueError("a cloud reaches outside points_flat")


def resample_gather(points_flat: np.ndarray, offsets: np.ndarray,
                    counts: np.ndarray, rows: np.ndarray, num_points: int,
                    seed: int, out: np.ndarray | None = None):
    """Resample each row's cloud to ``num_points`` points with replacement
    and gather them: (B, num_points, 3) float32, or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points_flat = np.ascontiguousarray(points_flat, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    _check_rows(points_flat, offsets, counts, rows)
    b = len(rows)
    if out is None:
        out = np.empty((b, num_points, 3), np.float32)
    elif (out.shape != (b, num_points, 3) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous float32 array of shape "
                         f"{(b, num_points, 3)}")
    lib.resample_gather(
        _ptr(points_flat, ctypes.c_float), _ptr(offsets, ctypes.c_int64),
        _ptr(counts, ctypes.c_int64), _ptr(rows, ctypes.c_int64),
        b, num_points, seed & 0xFFFFFFFFFFFFFFFF,
        _ptr(out, ctypes.c_float),
    )
    return out


def gather_labels(labels: np.ndarray, rows: np.ndarray):
    """``labels[rows]`` of a (n_rows, dim) matrix in float64, or None when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.float64)
    rows = np.ascontiguousarray(rows, np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= len(labels)):
        raise ValueError(f"rows outside [0, {len(labels)})")
    out = np.empty((len(rows), labels.shape[1]), np.float64)
    lib.gather_labels(
        _ptr(labels, ctypes.c_double), _ptr(rows, ctypes.c_int64),
        len(rows), labels.shape[1], _ptr(out, ctypes.c_double),
    )
    return out


# ------------------------------------------------------- the numpy twin

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_LO32 = np.uint64(0xFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 of a uint64 array, wrapping as C's uint64_t does."""
    x = x + _GAMMA
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def _mul_high(r: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The high 64 bits of r * count for count < 2**32, from r's 32-bit
    halves: r * c = hi * c * 2**32 + lo * c, and hi * c + (lo * c >> 32)
    stays below 2**64."""
    hi, lo = r >> np.uint64(32), r & _LO32
    return (hi * count + ((lo * count) >> np.uint64(32))) >> np.uint64(32)


def resample_gather_plain(points_flat: np.ndarray, offsets: np.ndarray,
                          counts: np.ndarray, rows: np.ndarray,
                          num_points: int, seed: int) -> np.ndarray:
    """``resample_gather`` in numpy, the same draws bit for bit, for clouds
    of fewer than 2**32 points."""
    points_flat = np.asarray(points_flat, np.float32)
    offsets = np.asarray(offsets, np.int64)
    counts = np.asarray(counts, np.int64)
    rows = np.asarray(rows, np.int64)
    if len(rows) and (counts[rows] >= 2 ** 32).any():
        raise ValueError("resample_gather_plain takes clouds of < 2**32 "
                         "points")
    _check_rows(points_flat, offsets, counts, rows)
    c = counts[rows]
    with np.errstate(over="ignore"):
        u_rows = rows.astype(np.uint64)
        ctr = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ _splitmix64(
            (u_rows << np.uint64(32)) ^ np.arange(len(rows), dtype=np.uint64)
            ^ np.uint64(0xA5A5A5A5DEADBEEF)))
        r = _splitmix64(ctr[:, None]
                        + np.arange(num_points, dtype=np.uint64)[None, :])
        pick = _mul_high(r, c.astype(np.uint64)[:, None]).astype(np.int64)
    out = np.zeros((len(rows), num_points, 3), np.float32)
    full = c > 0
    out[full] = points_flat[offsets[rows][full][:, None] + pick[full]]
    return out
