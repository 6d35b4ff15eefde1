"""The port's copies of the training host code against the JAX package:
``generate_dataset`` (the same files), ``PackedDataset`` (the same packed
arrays, and ``sample_batch`` bit-equal to the JAX numpy path from the same
generator, the native default in tests/test_torch_native_loader.py), the
meta helpers, ``PrefetchIterator``, ``metrics.evaluate`` (the same
eval.json), ``metrics.evaluate_held`` (the same track files) and
``save_config``."""

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
    got = td.sample_batch(idx, 64, np.random.default_rng(11),
                          use_native=False)
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
    """No provider path is left unported: ``use_native=True``, the
    default, runs the port's native assembler. It draws two seeds from the
    generator and resamples every cloud from its own points, empty clouds
    as zeros, with the labels of the numpy path."""
    td = tp.PackedDataset(datasets["port"], cache=False)
    idx = [7, 0, 3, 3, 12, 9]
    rng = np.random.default_rng(0)
    native = td.sample_batch(idx, 48, rng, use_native=True)
    drawn = np.random.default_rng(0)
    drawn.integers(0, 2 ** 63, 2)  # the two seeds, and nothing else
    assert rng.bit_generator.state == drawn.bit_generator.state
    default = td.sample_batch(idx, 48, np.random.default_rng(0))
    numpy_path = td.sample_batch(idx, 48, np.random.default_rng(0),
                                 use_native=False)
    for a, b in zip(native, default):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(native[0], numpy_path[0])
    for a, b in zip(native[2:], numpy_path[2:]):
        np.testing.assert_array_equal(a, b)
    rows = td.rows(idx)
    for k in (1, 2):
        pcs = native[k - 1]
        assert pcs.shape == (len(idx), 48, 3) and pcs.dtype == np.float32
        for b, row in enumerate(rows):
            o, c = getattr(td, f"offsets{k}")[row], getattr(td,
                                                            f"counts{k}")[row]
            src = np.asarray(getattr(td, f"points{k}")[o:o + c])
            assert (pcs[b][:, None] == src[None]).all(-1).any(-1).all()


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
    # the velocity-only eval of Held-style metas: the same track files
    held_metas = [{"trackid": i % 3, "frames": [i // 3, i // 3 + 1],
                   "timestamps": [0.1 * (i // 3), 0.1 * (i // 3) + 0.03 * (
                       i % 2) + 0.1]} for i in range(n)]
    vel = {}
    for name, mod, conf in (("jax", jm, jax_config), ("port", tm, tconfig)):
        vel[name] = mod.evaluate_held(
            conf.config_from_dict(cfg), list(range(n)), args[0], args[1],
            args[2], args[3], eval_dir=str(tmp_path / name / "held"),
            mean_time=0.5, metas=held_metas)
    assert dict(vel["port"][0]) == dict(vel["jax"][0])
    assert vel["port"][1] == vel["jax"][1] == {"mean_time": 0.5}
    names = sorted(os.listdir(tmp_path / "jax" / "held"))
    assert names == sorted(os.listdir(tmp_path / "port" / "held"))
    assert len(names) == 3
    for f in names:
        assert filecmp.cmp(tmp_path / "jax" / "held" / f,
                           tmp_path / "port" / "held" / f, shallow=False)


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
