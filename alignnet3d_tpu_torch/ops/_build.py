"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
         -Xcompiler -fPIC -c alignnet3d_tpu_torch/csrc/<name>.cu   # each
    nvcc -shared -o build/kernels/libalignnet3d_kernels_<hash>.so *.o

The build runs at first use, inside the checkout (``build/kernels/``,
listed in ``.gitignore``). The library's name carries a hash of the
sources and the flags, so a stale library is never loaded. Nothing here
runs at import time: the CPU tests import every module of the package on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (  # compile flags of every source; the link adds -shared
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C prototypes of the launchers, in csrc/*.cu; every one returns the CUDA
# error code of its launch.
_SIGNATURES = {
    "fused_pointnet_launch": (
        _P, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_P),
        ctypes.POINTER(_P), _I, _P, _P,
    ),
    "nn_table_launch": (_P, _P, _I, _I, _I, _P, _P, _P),
    "nn_argmin_launch": (
        _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
    ),
    "knn_points_launch": (_P, _I, _I, _I, _P, _P),
    "edge_stage_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "edge_train_stats1_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "edge_train_fwd_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    "edge_train_select_launch": (_P, _I, _I, _I, _P, _P, _P),
    "edge_train_bwd2_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "edge_train_bwd_mid_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    "edge_train_bwd_in_launch": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
    "edge_train_reduce_launch": (_P, _I, _I, _P, _P),
    "icp_update_launch": (
        _P, _P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P,
    ),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libalignnet3d_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}")


def build() -> Path:
    """Compile the kernels if their library is missing; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, compiles = [], []
        for src in _sources():
            if src.suffix == ".cu":
                objs.append(os.path.join(work, src.stem + ".o"))
                compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src),
                                 "-o", objs[-1]])
        _run(compiles)
        tmp = os.path.join(work, lib.name)
        _run([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]])
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with every launcher's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
