"""The port's copies of ``utils/data_prep.py`` and ``utils/viz.py``: the
cases of tests/test_dataprep_viz.py on the port, and the files each writes
against the JAX module's (HDF5 arrays, PLY points, the HTML viewer's
layers). matplotlib and h5py are optional (the card's machine lacks both):
the tests that need one skip without it."""

import json
import os

import numpy as np
import pytest

from alignnet3d_tpu.utils import data_prep as jax_data_prep
from alignnet3d_tpu.utils import viz as jax_viz
from alignnet3d_tpu_torch.utils import data_prep, viz


def test_h5_roundtrip(tmp_path, rng):
    pytest.importorskip("h5py")
    data = rng.normal(size=(4, 32, 3)).astype(np.float32)
    label = np.arange(4, dtype=np.uint8)
    path = str(tmp_path / "x.h5")
    data_prep.save_h5(path, data, label, data_dtype="float32")
    d, lab = data_prep.load_h5(path)
    np.testing.assert_allclose(d, data)
    np.testing.assert_array_equal(lab, label)
    # the JAX module reads what the port writes
    jd, jl = jax_data_prep.load_h5(path)
    np.testing.assert_array_equal(jd, d)
    np.testing.assert_array_equal(jl, lab)


def test_h5_with_normals(tmp_path, rng):
    pytest.importorskip("h5py")
    data = rng.normal(size=(2, 16, 3)).astype(np.float32)
    normal = rng.normal(size=(2, 16, 3)).astype(np.float32)
    label = np.zeros(2, np.uint8)
    path = str(tmp_path / "n.h5")
    jax_data_prep.save_h5_data_label_normal(path, data, label, normal)
    d, lab, n = data_prep.load_h5_data_label_normal(path)
    np.testing.assert_array_equal(n, normal)
    np.testing.assert_array_equal(d, data)


def test_ply_prep_roundtrip(tmp_path, rng):
    pc = rng.normal(size=(20, 3))
    path, jpath = str(tmp_path / "p.ply"), str(tmp_path / "j.ply")
    data_prep.export_ply(pc, path)
    jax_data_prep.export_ply(pc, jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back = data_prep.load_ply_data(path, 10)
    np.testing.assert_allclose(back, pc[:10], atol=1e-6)
    assert data_prep.get_sampling_command("a.obj", "b.ply") == \
        jax_data_prep.get_sampling_command("a.obj", "b.ply")


@pytest.mark.parametrize("row,pad", [(5, "edge"), (2, "edge"),
                                     (5, "constant")])
def test_pad_arr_rows(row, pad):
    arr = np.arange(6, dtype=float).reshape(3, 2)
    out = data_prep.pad_arr_rows(arr, row, pad)
    np.testing.assert_array_equal(out, jax_data_prep.pad_arr_rows(arr, row,
                                                                  pad))
    assert out.shape == (row, 2)
    if row > 3 and pad == "edge":
        np.testing.assert_array_equal(out[3], arr[-1])


def test_render_pair_writes_png(tmp_path, rng):
    pytest.importorskip("matplotlib")
    pc1 = rng.normal(size=(50, 3)) + [5, 0, 0]
    pc2 = pc1 + [0.5, 0.2, 0.0]
    out = str(tmp_path / "pair.png")
    fig = viz.render_pair(
        pc1, pc2, pred_translation=[0.5, 0.2, 0.0], pred_angle=0.0,
        gt_translation=[0.5, 0.2, 0.0], gt_angle=0.0, out_path=out,
    )
    assert os.path.isfile(out) and os.path.getsize(out) > 1000
    labels = [t.get_text() for t in fig.axes[0].get_legend().get_texts()]
    assert labels == ["pc1", "pc2", "pc1 @ prediction", "pc1 @ ground truth"]


def _layers(path):
    text = open(path).read()
    return text, json.loads(text.split("const LAYERS = ")[1].split(";\n")[0])


def test_export_html_scene_matches_jax(tmp_path, rng):
    pc1 = rng.normal(size=(40, 3)).astype(np.float32) + [5, 0, 0]
    pc2 = pc1 + [0.3, -0.1, 0.0]
    kwargs = dict(pred_translation=[0.3, -0.1, 0.0], pred_angle=0.1,
                  pred_center=pc1.mean(0), gt_translation=[0.3, -0.1, 0.0],
                  gt_angle=0.0, gt_center=pc1.mean(0),
                  extra_layers=[("refined", pc1 + 0.01)])
    out, jout = str(tmp_path / "scene.html"), str(tmp_path / "jax.html")
    viz.export_html_scene(pc1, pc2, out, **kwargs)
    jax_viz.export_html_scene(pc1, pc2, jout, **kwargs)
    text, layers = _layers(out)
    # standalone: no external scripts or links
    assert "src=" not in text and "http" not in text.split("<body>")[1]
    assert [layer["name"] for layer in layers] == [
        "pc1", "pc2", "pc1 @ prediction", "pc1 @ ground truth", "centers",
        "refined"]
    assert all(len(layer["pts"]) > 0 for layer in layers)
    assert layers == _layers(jout)[1]


def test_render_eval_samples(tmp_path):
    """Overlays of an eval directory's predictions for chosen val pairs,
    the viewer of each against the JAX module's from the same files."""
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.data.synthetic import generate_dataset

    pytest.importorskip("matplotlib")
    base = str(tmp_path / "ds")
    generate_dataset(base, num_train=2, num_val=3, seed=2, vres=16, hres=180)
    eval_dir = tmp_path / "eval"
    eval_dir.mkdir()
    rng = np.random.default_rng(3)
    np.save(eval_dir / "pred_translations.npy",
            rng.normal(size=(3, 3)).astype(np.float32))
    np.save(eval_dir / "pred_angles.npy",
            rng.normal(size=(3, 1)).astype(np.float32))
    np.save(eval_dir / "pred_s2_pc1centers.npy",
            rng.normal(size=(3, 3)).astype(np.float32))
    cfg = config_from_dict({"data": {"basepath": base}})
    viz.render_eval_samples(cfg, str(eval_dir), [0, 2], str(tmp_path / "o"),
                            html=True)
    names = sorted(os.listdir(tmp_path / "o"))
    assert len(names) == 4 and names[0].endswith(".html")
    import shutil

    from alignnet3d_tpu.config import config_from_dict as jax_cfg
    shutil.copytree(base, str(tmp_path / "jds"))
    jax_viz.render_eval_samples(jax_cfg({"data": {
        "basepath": str(tmp_path / "jds")}}), str(eval_dir), [0, 2],
        str(tmp_path / "j"), html=True)
    for name in names:
        if name.endswith(".html"):
            assert _layers(tmp_path / "o" / name)[1] == \
                _layers(tmp_path / "j" / name)[1]
