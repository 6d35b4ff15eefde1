"""The port's batch assembler (``alignnet3d_tpu_torch/data/native_loader.py``
over its copy ``csrc/loader.cpp``) against the JAX package's
(``alignnet3d_tpu/data/native_loader.py`` over ``native/loader.cpp``) on
the CPU: the library, its numpy twin and the JAX binding bit-equal on
ragged clouds with an empty one; ``gather_labels``; ``sample_batch`` with
both packages' defaults (the native path) bit-equal on the uniform
arrays, the component-filtered view and the voxel view; and, with the
libraries unavailable, the same numpy fallback stream in both packages."""

import os
import shutil

import numpy as np
import pytest

from alignnet3d_tpu.data import native_loader as jnl
from alignnet3d_tpu.data import provider as jp
from alignnet3d_tpu_torch.data import native_loader as tnl
from alignnet3d_tpu_torch.data import provider as tp
from alignnet3d_tpu_torch.data.synthetic import generate_dataset


def _ragged(seed, n_clouds=12, max_pts=700):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_pts, n_clouds).astype(np.int64)
    counts[3] = 0  # one empty cloud
    offsets = np.zeros(n_clouds + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = rng.normal(size=(int(counts.sum()), 3)).astype(np.float32)
    rows = rng.integers(0, n_clouds, 9).astype(np.int64)
    rows[1] = 3
    return flat, offsets, counts, rows, int(rng.integers(0, 2 ** 63))


@pytest.fixture(scope="module")
def libs():
    port, jax_lib = tnl.get_lib(), jnl.get_lib()
    assert port is not None, "the port's loader did not build"
    if jax_lib is None:
        pytest.skip("the JAX package's native loader did not build")
    return port, jax_lib


def test_the_port_builds_its_own_library(libs):
    port, jax_lib = libs
    assert os.path.realpath(port._name) == os.path.realpath(
        tnl.library_path())
    assert tnl.library_path().parent == tnl.BUILD_DIR
    assert "native" not in tnl.library_path().parts
    assert port._name != jax_lib._name
    assert port.loader_abi_version() == tnl.ABI_VERSION == 1


@pytest.mark.parametrize("seed,num_points", [(0, 64), (1, 512), (2, 1)])
def test_library_twin_and_jax_are_bit_equal(libs, seed, num_points):
    flat, offsets, counts, rows, s = _ragged(seed)
    got = tnl.resample_gather(flat, offsets, counts, rows, num_points, s)
    twin = tnl.resample_gather_plain(flat, offsets, counts, rows, num_points,
                                     s)
    want = jnl.resample_gather(flat, offsets, counts, rows, num_points, s)
    assert got.shape == (len(rows), num_points, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twin, want)
    assert not got[1].any()  # the empty cloud draws zeros
    # each point comes from its own cloud
    for b, row in enumerate(rows):
        src = flat[offsets[row]:offsets[row] + counts[row]]
        if len(src):
            assert (got[b][:, None] == src[None]).all(-1).any(-1).all()
    # another seed, another draw; the out buffer is filled in place
    other = tnl.resample_gather(flat, offsets, counts, rows, num_points,
                                s + 1)
    assert num_points == 1 or not np.array_equal(other, got)
    out = np.empty_like(got)
    assert tnl.resample_gather(flat, offsets, counts, rows, num_points, s,
                               out=out) is out
    np.testing.assert_array_equal(out, got)


def test_gather_labels_is_the_jax_packages(libs):
    rng = np.random.default_rng(4)
    labels = rng.normal(size=(20, 7))
    rows = np.array([3, 19, 0, 3], np.int64)
    got = tnl.gather_labels(labels, rows)
    np.testing.assert_array_equal(got, jnl.gather_labels(labels, rows))
    np.testing.assert_array_equal(got, labels[rows])


def test_bad_rows_and_the_twins_bound_raise(libs):
    flat, offsets, counts, rows, s = _ragged(5)
    with pytest.raises(ValueError, match="rows"):
        tnl.resample_gather(flat, offsets, counts, np.array([12]), 8, s)
    with pytest.raises(ValueError, match="outside points_flat"):
        tnl.resample_gather(flat[:10], offsets, counts, rows, 8, s)
    with pytest.raises(ValueError, match="rows"):
        tnl.gather_labels(np.zeros((2, 3)), np.array([2]))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tnl.resample_gather_plain(flat, np.array([0, 0]),
                                  np.array([2 ** 32]), np.array([0]), 4, s)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("native") / "src")
    generate_dataset(base, num_train=10, num_val=4, seed=6, vres=16,
                     hres=180)
    return base


@pytest.fixture
def pair(source, tmp_path):
    """Each package packs its own copy: both write caches beside it."""
    out = []
    for name, mod in (("jax", jp), ("port", tp)):
        base = str(tmp_path / name)
        shutil.copytree(source, base)
        out.append(mod.PackedDataset(base))
    return out


def _same_batches(jd, td, idx, num_points, seed, **kw):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the generators advance alike
        want = jd.sample_batch(idx, num_points, rj, **kw)
        got = td.sample_batch(idx, num_points, rt, **kw)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("view", ["uniform", "denoised", "voxel"])
def test_sample_batch_is_bit_equal_to_the_jax_default(libs, pair, view):
    jd, td = pair
    if view == "denoised":
        for ds in pair:
            ds.enable_component_filter(0.5, "central")
    if view == "voxel":
        for ds in pair:
            ds.enable_voxel_resample(0.1)
    got = _same_batches(jd, td, [7, 0, 3, 3, 12, 9], 64, 11)
    # the native stream, not the numpy one
    numpy_path = td.sample_batch([7, 0, 3, 3, 12, 9], 64,
                                 np.random.default_rng(11), use_native=False)
    assert not np.array_equal(numpy_path[0], got[0])


def test_both_packages_fall_back_to_the_same_numpy_stream(libs, pair,
                                                          monkeypatch):
    """Without a library, each package draws the two seeds and then runs
    its numpy path, so the fallback stream is the numpy path's on a
    generator advanced by those draws, alike in both packages."""
    jd, td = pair
    monkeypatch.setattr(jnl, "get_lib", lambda: None)
    monkeypatch.setattr(tnl, "get_lib", lambda: None)
    idx = [1, 4, 4, 13]
    got = _same_batches(jd, td, idx, 32, 3)
    rng = np.random.default_rng(3)
    rng.integers(0, 2 ** 63, 2)
    first = td.sample_batch(idx, 32, rng, use_native=False)
    rng = np.random.default_rng(3)
    again = td.sample_batch(idx, 32, rng)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (4, 32, 3)
    for ds in pair:
        ds.enable_voxel_resample(0.1)
    _same_batches(jd, td, idx, 32, 5)
