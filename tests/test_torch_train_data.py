"""The port's copies of the training host code against the JAX package:
``generate_dataset`` (the same files), ``PackedDataset`` (the same packed
arrays, and ``sample_batch`` bit-equal to the JAX numpy path from the same
generator), the meta helpers, ``PrefetchIterator``, ``metrics.evaluate``
(the same eval.json) and ``save_config``."""

import filecmp
import json
import os

import numpy as np
import pytest

from alignnet3d_tpu import config as jax_config
from alignnet3d_tpu.data import provider as jp
from alignnet3d_tpu.data import synthetic as jsyn
from alignnet3d_tpu.evaluation import metrics as jm
from alignnet3d_tpu_torch import config as tconfig
from alignnet3d_tpu_torch import geometry as tgeo
from alignnet3d_tpu_torch.data import provider as tp
from alignnet3d_tpu_torch.data import synthetic as tsyn
from alignnet3d_tpu_torch.evaluation import metrics as tm


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    paths = {}
    for name, gen in (("jax", jsyn.generate_dataset),
                      ("port", tsyn.generate_dataset)):
        paths[name] = str(root / name)
        gen(paths[name], num_train=10, num_val=5, seed=3, vres=16, hres=180)
    return paths


def test_generate_dataset_writes_the_same_files(datasets):
    for sub in ("meta", "pointcloud1", "pointcloud2", "split"):
        a, b = (os.path.join(datasets[k], sub) for k in ("jax", "port"))
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and names
        match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)


def test_meta_helpers_match(datasets):
    base = datasets["port"]
    assert tp.getDataFiles(f"{base}/split/val.txt") == \
        jp.getDataFiles(f"{base}/split/val.txt")
    meta = tp.load_meta(base, 2)
    assert meta == jp.load_meta(base, 2)
    for got, want in zip(tp.parse_meta_labels(meta),
                         jp.parse_meta_labels(meta)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cache", [True, False])
def test_sample_batch_is_bit_equal_to_the_jax_numpy_path(datasets, tmp_path,
                                                         cache):
    # each package packs its own copy of the port's dataset directory
    import shutil

    bases = {}
    for name in ("jax", "port"):
        bases[name] = str(tmp_path / name)
        shutil.copytree(datasets["port"], bases[name])
    jd = jp.PackedDataset(bases["jax"], cache=cache)
    td = tp.PackedDataset(bases["port"], cache=cache)
    for attr in ("indices", "counts1", "counts2", "offsets1", "points2",
                 "translations", "pc2angles"):
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr))
    if cache:
        for f in ("packed_v2_points1.npy", "packed_v2_points2.npy"):
            assert filecmp.cmp(os.path.join(bases["jax"], f),
                               os.path.join(bases["port"], f), shallow=False)
    idx = [7, 0, 3, 3, 12, 9]
    got = td.sample_batch(idx, 64, np.random.default_rng(11))
    want = jd.sample_batch(idx, 64, np.random.default_rng(11),
                           use_native=False)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert td.metas(idx) == jd.metas(idx)
    # a reopened cache loads the same arrays
    if cache:
        again = tp.PackedDataset(bases["port"])
        np.testing.assert_array_equal(again.points1, td.points1)


def test_unported_provider_paths_raise(datasets):
    """The native assembler is the one path left (the two views are held
    to the JAX package in tests/test_torch_views.py)."""
    td = tp.PackedDataset(datasets["port"], cache=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td.sample_batch([0], 8, np.random.default_rng(0), use_native=True)


def test_prefetch_iterator_order_and_errors():
    assert list(tp.PrefetchIterator(lambda i: i * i, 5, 2)) == [0, 1, 4, 9, 16]

    def bad(i):
        if i == 2:
            raise KeyError("boom")
        return i

    it = tp.PrefetchIterator(bad, 4, 1)
    assert [next(it), next(it)] == [0, 1]
    with pytest.raises(KeyError):
        next(it)


def _eval_inputs(seed, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(n, 3) * 0.1, f(n, 1), f(n, 3) * 0.1, f(n, 1), f(n, 3),
            f(n, 3) * 8)


@pytest.mark.parametrize("accept_inverted", [False, True])
def test_evaluate_matches_jax(tmp_path, accept_inverted):
    """The same numbers and the same eval.json, KITTI-style metas with
    tracks (velocity files) among them."""
    n = 24
    args = _eval_inputs(1, n)
    metas = [{"trackids": [i % 11, 0], "seq": i % 3, "frames": [i, i + 1]}
             if i % 2 else None for i in range(n)]
    cfg = {"data": {"basepath": "/data/SynthCars"}}
    out = {}
    for name, mod, conf in (("jax", jm, jax_config), ("port", tm, tconfig)):
        eval_dir = str(tmp_path / name)
        out[name] = mod.evaluate(
            conf.config_from_dict(cfg), list(range(n)), *args,
            eval_dir=eval_dir, accept_inverted_angle=accept_inverted,
            mean_time=0.25, metas=metas)
    assert tm.ns_to_dict(out["port"]) == jm.ns_to_dict(out["jax"])
    fname = "eval_180.json" if accept_inverted else "eval.json"
    for name in out:
        assert os.path.isfile(tmp_path / name / fname)
    with open(tmp_path / "jax" / fname) as a, \
            open(tmp_path / "port" / fname) as b:
        assert json.load(a) == json.load(b)
    vel = sorted(os.listdir(tmp_path / "jax" / "velocities"))
    assert vel == sorted(os.listdir(tmp_path / "port" / "velocities"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.evaluate_held()


def test_geometry_and_config_helpers_match(tmp_path):
    from alignnet3d_tpu import geometry as jgeo

    t, a, c, _, _, g = _eval_inputs(2, 16)
    np.testing.assert_array_equal(
        tgeo.translate_transform_to_new_center_of_rotation(t, a, c, g),
        jgeo.translate_transform_to_new_center_of_rotation(t, a, c, g))
    np.testing.assert_array_equal(tgeo.wrap_angle(a * 9), jgeo.wrap_angle(a * 9))
    arr = np.arange(6.0).reshape(2, 3) / 7
    for plain in (True, False):
        assert tgeo.np_to_str(arr, plain) == jgeo.np_to_str(arr, plain)
        np.testing.assert_array_equal(
            tgeo.str_to_np(tgeo.np_to_str(arr, plain), plain), arr)
    d = {"training": {"batch_size": 3}, "model": {"num_points": 16}}
    tconfig.save_config(str(tmp_path / "t.json"), tconfig.config_from_dict(d))
    saved = json.load(open(tmp_path / "t.json"))
    assert saved == jax_config.namespace_to_dict(
        jax_config.config_from_dict(d), {})
    with pytest.raises(ValueError, match="json"):
        tconfig.save_config(str(tmp_path / "t.txt"))
