"""The port's two dataset views against the JAX package's: the component
filter (data.denoise) and the voxel resampling view (data.resample) give
the same counts, points and cache files, and ``sample_batch`` draws
bit-equal batches from them on the numpy path (``use_native=False`` on
both sides; the native default is held to the JAX package's in
tests/test_torch_native_loader.py). Every comparison is exact: both run
the same numpy code on the same arrays."""

import filecmp
import os
import shutil

import numpy as np
import pytest

from alignnet3d_tpu.data import provider as jp
from alignnet3d_tpu_torch.data import provider as tp
from alignnet3d_tpu_torch.data.synthetic import generate_dataset


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A synthetic dataset whose clouds each carry a far clutter cluster,
    so that the component filter has something to remove."""
    base = str(tmp_path_factory.mktemp("views") / "src")
    generate_dataset(base, num_train=6, num_val=4, seed=5, vres=16, hres=180)
    rng = np.random.default_rng(9)
    for k in (1, 2):
        folder = os.path.join(base, f"pointcloud{k}")
        for name in sorted(os.listdir(folder)):
            pc = np.load(os.path.join(folder, name))
            clutter = rng.normal(0, 0.2, (30, pc.shape[1]))
            clutter[:, :3] += [30.0, -25.0, 0.5]
            np.save(os.path.join(folder, name),
                    np.concatenate([pc, clutter]).astype(pc.dtype))
    return base


@pytest.fixture
def pair(source, tmp_path):
    """The JAX and the port's PackedDataset, each on its own copy."""
    out = []
    for name, mod in (("jax", jp), ("port", tp)):
        path = str(tmp_path / name)
        shutil.copytree(source, path)
        out.append(mod.PackedDataset(path))
    return out


def _caches(path):
    return sorted(f for f in os.listdir(path)
                  if f.startswith("packed_v2_") and ("_dn" in f or "_vox" in f))


def _same_arrays(jd, td):
    for k in (1, 2):
        for attr in (f"counts{k}", f"offsets{k}", f"points{k}"):
            np.testing.assert_array_equal(np.asarray(getattr(td, attr)),
                                          np.asarray(getattr(jd, attr)))


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("keep", ["central", "largest"])
def test_component_filter_matches_jax(pair, cache, keep):
    jd, td = pair
    before = td.counts1.copy()
    jd.enable_component_filter(0.5, keep, cache=cache)
    td.enable_component_filter(0.5, keep, cache=cache)
    _same_arrays(jd, td)
    # one of the two components went (on a small cloud the clutter is the
    # larger one)
    assert (td.counts1 < before).all()
    assert td._denoise_tag == jd._denoise_tag == f"dn0.5{keep[0]}"
    names = _caches(td.basepath)
    assert names == _caches(jd.basepath)
    assert bool(names) == cache
    for f in names:
        if f.endswith(".npy"):
            assert filecmp.cmp(os.path.join(jd.basepath, f),
                               os.path.join(td.basepath, f), shallow=False)
    if cache:  # a second dataset loads the filtered view from the cache
        again = tp.PackedDataset(td.basepath)
        again.enable_component_filter(0.5, keep)
        _same_arrays(jd, again)


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("denoise", [False, True])
def test_voxel_view_and_its_draws_match_jax(pair, cache, denoise):
    jd, td = pair
    if denoise:
        jd.enable_component_filter(0.5, "central", cache=cache)
        td.enable_component_filter(0.5, "central", cache=cache)
    jd.enable_voxel_resample(0.1, cache=cache)
    td.enable_voxel_resample(0.1, cache=cache)
    for k in (1, 2):
        for got, want in zip(td._vox[k], jd._vox[k]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert td._vox_size == 0.1
    assert (td._vox[1][2] < td.counts1).any()  # the view dedups
    assert td._vox_cache_files(1, 0.1)[0].endswith(
        "_dn0.5c_points.npy" if denoise else "vox1_0.1_points.npy")
    assert _caches(td.basepath) == _caches(jd.basepath)
    idx = [3, 0, 9, 3, 5]
    for draw in range(2):  # the generator advances alike
        rj, rt = (np.random.default_rng(20 + draw) for _ in range(2))
        want = jd.sample_batch(idx, 48, rj, use_native=False)
        got = td.sample_batch(idx, 48, rt, use_native=False)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_port_loads_the_caches_the_jax_package_wrote(pair):
    """Both packages share the cache stems and their validation, so either
    one loads what the other built."""
    jd, _ = pair
    jd.enable_component_filter(0.5, "largest")
    jd.enable_voxel_resample(0.05)
    td = tp.PackedDataset(jd.basepath)
    td.enable_component_filter(0.5, "largest")
    td.enable_voxel_resample(0.05)
    _same_arrays(jd, td)
    assert isinstance(td._vox[1][0], np.memmap)  # read, not rebuilt
    np.testing.assert_array_equal(np.asarray(td._vox[2][0]),
                                  np.asarray(jd._vox[2][0]))


def test_empty_cloud_draws_zeros_in_the_voxel_view(tmp_path, source):
    base = str(tmp_path / "empty")
    shutil.copytree(source, base)
    np.save(os.path.join(base, "pointcloud2", "00000001.npy"),
            np.zeros((0, 3), np.float32))
    jd = jp.PackedDataset(base, cache=False)
    td = tp.PackedDataset(base, cache=False)
    for ds in (jd, td):
        ds.enable_voxel_resample(0.1, cache=False)
    want = jd.sample_batch([1, 0], 16, np.random.default_rng(1),
                           use_native=False)
    got = td.sample_batch([1, 0], 16, np.random.default_rng(1),
                          use_native=False)
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1][0].any()


def test_component_filter_must_precede_the_voxel_view(pair):
    _, td = pair
    td.enable_voxel_resample(0.1, cache=False)
    with pytest.raises(ValueError, match="before the voxel view"):
        td.enable_component_filter(0.5, "largest")
