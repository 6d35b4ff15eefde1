"""The port's KITTI and Held toolchain against the JAX package on the CPU:
``data/kitti.py`` (calibration, tracking labels, box geometry, object
extraction, the FOV and colour helpers, relative transforms, the scene
writer), ``data/held.py``, ``data/kitti_generate.py`` on the synthetic mini
KITTI tree of tests/test_kitti_configs_e2e.py (the same files, byte for
byte, for the four config recipes), the four repo KITTI configs training
one epoch through the port's CLI from a pretrained run as their recipe
says, and ``evaluation.special.mode 'held'`` through both CLIs from one
JAX ``.msgpack`` run.

Tolerances: the numpy helpers and the generated files exactly (the same
numpy code on the same inputs); the held velocities within 1e-4 relative
(the float32 forward's summation order, tests/test_torch_slice.py).
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_kitti import LABELS
from test_kitti_configs_e2e import CONFIGS, FRAMES, _build_tree

from alignnet3d_tpu.data import held as jheld
from alignnet3d_tpu.data import kitti as jk
from alignnet3d_tpu.data.kitti_generate import (
    generate_kitti_dataset as jax_generate,
)
from alignnet3d_tpu_torch import cli
from alignnet3d_tpu_torch.data import held as theld
from alignnet3d_tpu_torch.data import kitti as tk
from alignnet3d_tpu_torch.data import kitti_generate as tgen
from alignnet3d_tpu_torch.data.synthetic import generate_dataset

torch.set_num_threads(1)

CALIBS = {
    "tracking": "P2: 700 0 600 40 0 700 180 2 0 0 1 0\n"
                "R_rect: 0.9999 0.01 0 -0.01 0.9999 0 0 0 1\n"
                "Tr_velo_cam: 0 -1 0 0.05 0 0 -1 -0.05 1 0 0 -0.27\n",
    "object": "P2: 100 0 50 0 0 100 50 0 0 0 1 0\n"
              "R0_rect: 1 0 0 0 1 0 0 0 1\n"
              "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n",
}
BOXES = (np.array([2.0, 1.0, 10.0, 1.5, 1.6, 4.0, 0.3]),
         np.array([1.0, 1.5, 12.0, 1.5, 1.6, 4.0, 0.5]),
         np.array([2.5, 1.0, 8.5, 1.5, 1.6, 4.0, 0.35]))


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _calibs(tmp_path):
    out = {}
    for name, text in CALIBS.items():
        path = tmp_path / f"{name}.txt"
        path.write_text(text)
        out[name] = (tk.Calibration(str(path)), jk.Calibration(str(path)))
    video = tmp_path / "video"
    video.mkdir()
    (video / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
        "P_rect_02: 700 0 600 0 0 700 180 0 0 0 1 0\n")
    (video / "calib_velo_to_cam.txt").write_text(
        "R: 0 -1 0 0 0 -1 1 0 0\nT: 0.1 -0.05 -0.27\n")
    out["video"] = (tk.Calibration.from_video_dir(str(video)),
                    jk.Calibration.from_video_dir(str(video)))
    return out


def test_calibration_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    velo = rng.normal(size=(50, 3)) * 10 + np.array([15, 0, 0])
    uvd = np.concatenate([rng.uniform(0, 1000, (20, 2)),
                          rng.uniform(2, 40, (20, 1))], axis=1)
    for name, (got, want) in _calibs(tmp_path).items():
        for attr in ("P", "V2C", "C2V", "R0", "c_u", "c_v", "f_u", "f_v",
                     "b_x", "b_y", "_velo2rect", "_rect2velo"):
            _same(getattr(got, attr), getattr(want, attr))
        for fn, arg in (("project_velo_to_rect", velo),
                        ("project_rect_to_velo", velo),
                        ("project_rect_to_image", velo),
                        ("project_velo_to_image", velo),
                        ("project_image_to_rect", uvd),
                        ("project_image_to_velo", uvd)):
            _same(getattr(got, fn)(arg), getattr(want, fn)(arg))
    path = str(tmp_path / "tracking.txt")
    got, want = (m.Calibration.read_calib_file(path) for m in (tk, jk))
    assert got.keys() == want.keys()
    for key in want:
        _same(got[key], want[key])


@pytest.mark.parametrize("kwargs", [
    {}, {"occluded_threshold": 1.0, "truncated_threshold": 0.5},
    {"remove_dontcare": False, "split_on_reappear": False},
    {"occluded_threshold": (1, 4)},
])
def test_tracking_labels_match_jax(tmp_path, kwargs):
    path = tmp_path / "0000.txt"
    path.write_text(LABELS + "garbage line\n")
    got, want = (m.TrackingLabels(str(path), **kwargs) for m in (tk, jk))
    assert got.rows == want.rows and got.ids == want.ids
    assert got.tracklets() == want.tracklets()
    assert got.by_frame() == want.by_frame()
    for row in want.rows:
        _same(tk.TrackingLabels.boxvec(row), jk.TrackingLabels.boxvec(row))


def test_box_geometry_and_extraction_match_jax():
    rng = np.random.default_rng(1)
    _same(tk.R_KITTI2GLOBAL, jk.R_KITTI2GLOBAL)
    assert tk.TRACKING_COLUMNS == jk.TRACKING_COLUMNS
    assert tk.TRACKING_CLASSES == jk.TRACKING_CLASSES
    tr = rng.normal(size=(3, 4))
    _same(tk.inverse_rigid_trans(tr), jk.inverse_rigid_trans(tr))
    for box in BOXES:
        _same(tk.roty(box[6]), jk.roty(box[6]))
        corners = tk.compute_box_3d(box)
        _same(corners, jk.compute_box_3d(box))
        pts = np.concatenate([corners, rng.normal(size=(200, 3)) * 3
                              + box[:3]])
        _same(tk.points_in_box_3d(pts, box), jk.points_in_box_3d(pts, box))
        scan = np.concatenate([pts @ tk.R_KITTI2GLOBAL,
                               np.ones((len(pts), 1))], axis=1)
        _same(tk.extract_object_points(scan, box),
              jk.extract_object_points(scan, box))
        _same(tk.get_transform_components(box),
              jk.get_transform_components(box))
    _same(tk.get_relative_transform(BOXES[0], BOXES[2]),
          jk.get_relative_transform(BOXES[0], BOXES[2]))
    vo = np.eye(4)
    vo[:3, :3] = tk.roty(0.2)
    vo[:3, 3] = [0.3, -0.1, 1.2]
    scan = rng.normal(size=(40, 4)).astype(np.float32)
    _same(tk.apply_visual_odometry(scan, vo),
          jk.apply_visual_odometry(scan, vo))


def test_fov_colour_and_scan_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    pc_velo = np.concatenate([rng.uniform(-5, 40, (300, 1)),
                              rng.uniform(-10, 10, (300, 2)),
                              np.ones((300, 1))], axis=1)
    image = rng.uniform(0, 255, (100, 120, 3))
    for got, want in _calibs(tmp_path).values():
        _same(tk.points_in_image_fov(pc_velo, got, 0, 0, 1200, 400),
              jk.points_in_image_fov(pc_velo, want, 0, 0, 1200, 400))
        _same(tk.extract_points_in_box2d(pc_velo, (100, 50, 900, 300), got,
                                         1200, 400),
              jk.extract_points_in_box2d(pc_velo, (100, 50, 900, 300), want,
                                         1200, 400))
        pts = pc_velo[:, :3] @ tk.R_KITTI2GLOBAL.T @ tk.R_KITTI2GLOBAL
        _same(tk.extract_colors_for_points(pts, got, image),
              jk.extract_colors_for_points(pts, want, image))
    path = str(tmp_path / "scan.bin")
    rng.normal(size=(37, 4)).astype(np.float32).tofile(path)
    _same(tk.load_velo_scan(path), jk.load_velo_scan(path))


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_scene_writers_write_the_same_files(tmp_path):
    rng = np.random.default_rng(3)
    row1 = {"frame": 3, "id": 4, "class": "Car", "truncated": 0.0,
            "occluded": 1.0, "x": 2.0, "y": 1.0, "z": 8.0, "xd": 1.5,
            "yd": 1.6, "zd": 4.0, "roty": 0.2}
    row2 = dict(row1, frame=4, x=2.2, z=8.3, roty=0.3)
    pc1, pc2 = rng.normal(size=(50, 3)), rng.normal(size=(60, 3))
    for name, mod, hmod in (("jax", jk, jheld), ("port", tk, theld)):
        scene = mod.FromKITTIScene(row1, row2, pc1, pc2, seq=7)
        scene.save(str(tmp_path / name / "kitti"), 0)
        held = hmod.FromHeldScene(9, 3, 4, (pc1, 0.1), (pc2, 0.2),
                                  obj_class="Pedestrian")
        held.save(str(tmp_path / name / "held"), 5)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    with open(tmp_path / "port" / "held" / "meta" / "00000005.json") as f:
        meta = json.load(f)
    assert meta["timestamps"] == [0.1, 0.2] and meta["trackid"] == 9


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    return _build_tree(str(tmp_path_factory.mktemp("kitti_tree")),
                       np.random.default_rng(4))


@pytest.fixture(scope="module")
def kitti_datasets(kitti_tree, tmp_path_factory):
    """Each config's dataset written by the port's generator."""
    out = str(tmp_path_factory.mktemp("port_datasets"))
    paths = {}
    for name, kwargs in CONFIGS.items():
        paths[name] = os.path.join(out, name)
        tgen.generate_kitti_dataset(kitti_tree, paths[name], use_vo=False,
                                    **kwargs)
    return paths


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_kitti_dataset_writes_the_jax_packages_files(
        name, kitti_tree, kitti_datasets, tmp_path):
    want = str(tmp_path / name)
    train_idx, val_idx = jax_generate(kitti_tree, want, use_vo=False,
                                      **CONFIGS[name])
    n_tracks = 2 if "Persons" in name else 1
    assert len(train_idx) == len(val_idx) == (FRAMES - 1) * n_tracks
    _same_tree(kitti_datasets[name], want)


def test_generate_with_visual_odometry_and_the_cli(kitti_tree, tmp_path):
    """Ego-motion files for some frames (identity assumed elsewhere), the
    sequence list and the class filter, through the port's argparse
    ``main`` and the JAX function alike."""
    root = str(tmp_path / "tree")
    shutil.copytree(kitti_tree, root)
    vo_dir = os.path.join(root, "preprocessed", "training", "visual_odometry")
    os.makedirs(vo_dir)
    rng = np.random.default_rng(5)
    for frame in range(0, FRAMES, 2):
        vo = np.eye(4)
        vo[:3, :3] = tk.roty(0.01 * frame)
        vo[:3, 3] = rng.normal(size=3) * 0.05
        np.savetxt(os.path.join(vo_dir, f"vo_0000_{frame:06d}.txt"), vo)
    want = str(tmp_path / "jax")
    jax_generate(root, want, classes=("Car", "Pedestrian"), sequences=[0, 2])
    got = str(tmp_path / "port")
    tgen.main(["--kitti_root", root, "--out", got, "--classes", "Car",
               "Pedestrian", "--sequences", "0", "2"])
    _same_tree(got, want)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The KITTI configs' recipe warm-starts from a SynthCars run: one
    epoch of configs/SynthCars.json (the same widths) through the port's
    CLI on a small synthetic dataset, at 64 points."""
    root = tmp_path_factory.mktemp("pretrained")
    base = str(root / "SynthCars")
    generate_dataset(base, num_train=8, num_val=4, seed=8, vres=12, hres=120)
    with open("configs/SynthCars.json") as f:
        cfg = json.load(f)
    cfg["data"]["basepath"] = base
    cfg["logging"] = {"basedir": str(root / "runs")}
    cfg["model"]["num_points"] = 64
    cfg["training"].update(num_epochs=1, batch_size=8)
    path = str(root / "SynthCars.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    cli.main(["train", "--config", path, "--device", "cpu"])
    return str(root / "runs" / "SynthCars" / "model-0")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kitti_config_trains_through_the_cli(name, kitti_datasets,
                                             pretrained, tmp_path):
    """Each repo KITTI config, unmodified but for its data, log directory,
    pretrained run and size knobs (one epoch, batch 8, 64 points), on the
    port's dataset: the 'pretr' eval of the restored run, one epoch and
    its eval."""
    with open(f"configs/{name}.json") as f:
        cfg = json.load(f)
    assert cfg["training"]["pretraining"]["model"]
    cfg["data"]["basepath"] = kitti_datasets[name]
    cfg["logging"] = {"basedir": str(tmp_path / "runs")}
    cfg["training"].update(num_epochs=1, batch_size=8,
                           pretraining={"model": pretrained})
    cfg["model"]["num_points"] = 64
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    trainer = cli.main(["train", "--config", path, "--device", "cpu"])
    assert trainer.step == trainer.num_batches_per_epoch > 0
    assert trainer.schedule_count == 1 + trainer.step  # the restored count
    run = tmp_path / "runs" / name
    for ev in ("eval0pretr", "eval000000"):
        with open(run / "val" / ev / "eval.json") as f:
            table = json.load(f)
        assert table["num"] == (FRAMES - 1) * (2 if "Persons" in name else 1)
        assert all(0.0 <= v <= 1.0 for v in table["corr_levels"])
    assert (run / "model-0.pt").is_file()


MODEL_OPTS = {  # tests/test_special_modes.py's held model
    "num_points": 48, "backbone": "pointnet",
    "options": {
        "angle_factor": 1.0, "early_stage_factor": 0.5,
        "s1transformer": [[16, 32], [[32], 0.7]],
        "s2transformer": [[16, 32], [[32], 0.7]],
        "embedding": [16, 64],
        "remaining_transform_prediction": [[32], 0.7],
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}


@pytest.fixture(scope="module")
def held_run(tmp_path_factory):
    """tests/test_special_modes.py's workspace: Held-style metas (track
    ids, frames, timestamps) on a synthetic dataset, and a JAX run of one
    epoch through the JAX CLI, saved as ``model-0.msgpack``."""
    from alignnet3d_tpu.cli import main as jax_main

    root = tmp_path_factory.mktemp("held")
    base = str(root / "jax" / "HeldData")
    generate_dataset(base, num_train=8, num_val=8, seed=31, vres=12,
                     hres=120)
    for i in range(16):
        path = f"{base}/meta/{i:08d}.json"
        with open(path) as f:
            meta = json.load(f)
        meta.update({"trackid": i % 2, "frames": [i // 2, i // 2 + 1],
                     "timestamps": [0.1 * (i // 2), 0.1 * (i // 2 + 1)]})
        with open(path, "w") as f:
            json.dump(meta, f)
    shutil.copytree(base, str(root / "port" / "HeldData"))
    train_cfg = {
        "data": {"basepath": base},
        "logging": {"basedir": str(root / "runs")},
        "model": MODEL_OPTS,
        "training": {"batch_size": 8, "num_epochs": 1,
                     "learning_rate": 0.005},
        "evaluation": {"save_every_epoch": True},
    }
    cfg_path = str(root / "HeldTrain.json")
    with open(cfg_path, "w") as f:
        json.dump(train_cfg, f)
    jax_main(["train", "--config", cfg_path])
    run = root / "runs" / "HeldTrain"
    assert (run / "model-0.msgpack").is_file()
    return root, str(run)


def _held_config(root, side, run):
    cfg = {
        "data": {"basepath": str(root / side / "HeldData")},
        "logging": {"basedir": str(root / side / "runs")},
        "model": MODEL_OPTS,
        "training": {"batch_size": 8, "num_epochs": 1},
        "evaluation": {"save_every_epoch": True,
                       "special": {"mode": "held", "held": {"model": run}}},
    }
    path = str(root / side / "Held.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _tracks(root, side):
    eval_dir = root / side / "runs" / "Held" / "val" / "eval000000"
    return {f: np.loadtxt(eval_dir / f) for f in sorted(os.listdir(eval_dir))
            if f.startswith("track")}


def test_held_mode_through_the_cli_matches_jax(held_run):
    from alignnet3d_tpu.cli import main as jax_main

    root, run = held_run
    jax_main(["eval_only", "--config", _held_config(root, "jax", run),
              "--eval_epoch", "0"])
    trainer = cli.main(["eval_only", "--config",
                        _held_config(root, "port", run), "--eval_epoch", "0",
                        "--device", "cpu"])
    assert trainer.step == 1  # the JAX run's step, read from the .msgpack
    got, want = _tracks(root, "port"), _tracks(root, "jax")
    assert list(got) == list(want) == ["track0.txt", "track1.txt"]
    for name in want:
        assert got[name].shape == want[name].shape == (4,)
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # the velocity-only eval writes no eval.json
    assert not (root / "port" / "runs" / "Held" / "val" / "eval000000"
                / "eval.json").exists()
