"""Dataset-prep IO helpers (HDF5 + PLY), equivalent of reference
utils/data_prep_util.py:15-131 for the ModelNet-style prep tooling.

The port's own copy of ``alignnet3d_tpu/utils/data_prep.py``."""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.utils.ply import read_ply, write_ply

SAMPLING_BIN = "./third_party/mesh_sampling/build/pcsample"
SAMPLING_POINT_NUM = 2048
SAMPLING_LEAF_SIZE = 0.005


def export_ply(pc: np.ndarray, filename: str):
    """(reference data_prep_util.py:15-20)."""
    write_ply(np.asarray(pc)[:, :3], filename, text=True)


def get_sampling_command(obj_filename: str, ply_filename: str) -> str:
    """(reference data_prep_util.py:23-26)."""
    return (
        f"{SAMPLING_BIN} {obj_filename} {ply_filename} "
        f"-n_samples {SAMPLING_POINT_NUM} -leaf_size {SAMPLING_LEAF_SIZE}"
    )


def save_h5_data_label_normal(h5_filename, data, label, normal,
                              data_dtype="float32", label_dtype="uint8",
                              normal_dtype="float32"):
    """(reference data_prep_util.py:60-76)."""
    import h5py

    with h5py.File(h5_filename, "w") as f:
        f.create_dataset("data", data=data, compression="gzip",
                         compression_opts=4, dtype=data_dtype)
        f.create_dataset("normal", data=normal, compression="gzip",
                         compression_opts=4, dtype=normal_dtype)
        f.create_dataset("label", data=label, compression="gzip",
                         compression_opts=1, dtype=label_dtype)


def save_h5(h5_filename, data, label, data_dtype="uint8",
            label_dtype="uint8"):
    """(reference data_prep_util.py:79-89)."""
    import h5py

    with h5py.File(h5_filename, "w") as f:
        f.create_dataset("data", data=data, compression="gzip",
                         compression_opts=4, dtype=data_dtype)
        f.create_dataset("label", data=label, compression="gzip",
                         compression_opts=1, dtype=label_dtype)


def load_h5_data_label_normal(h5_filename):
    import h5py

    with h5py.File(h5_filename, "r") as f:
        return f["data"][:], f["label"][:], f["normal"][:]


def load_h5_data_label_seg(h5_filename):
    import h5py

    with h5py.File(h5_filename, "r") as f:
        return f["data"][:], f["label"][:], f["pid"][:]


def load_h5(h5_filename):
    import h5py

    with h5py.File(h5_filename, "r") as f:
        return f["data"][:], f["label"][:]


def load_ply_data(filename, point_num=None):
    """xyz of the first ``point_num`` vertices
    (reference data_prep_util.py:119-123)."""
    vertex = read_ply(filename)["vertex"]
    if point_num is not None:
        vertex = vertex[:point_num]
    return np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=-1)


def load_ply_normal(filename, point_num=None):
    """(nx, ny, nz) of the first ``point_num`` vertices
    (reference data_prep_util.py:126-130)."""
    vertex = read_ply(filename)["vertex"]
    if point_num is not None:
        vertex = vertex[:point_num]
    return np.stack([vertex["nx"], vertex["ny"], vertex["nz"]], axis=-1)


def pad_arr_rows(arr, row, pad="edge"):
    """Pad/clip an (N, k) array to exactly ``row`` rows
    (reference data_prep_util.py:134-144)."""
    arr = np.asarray(arr)
    assert arr.ndim == 2
    if arr.shape[0] >= row:
        return arr[:row]
    if pad == "edge":
        return np.pad(arr, ((0, row - arr.shape[0]), (0, 0)), mode="edge")
    if pad == "constant":
        return np.pad(arr, ((0, row - arr.shape[0]), (0, 0)),
                      mode="constant")
    raise ValueError(pad)
