"""The port's host tail against the JAX package on seeded inputs: the
geometry tail (``angle_diff``, ``heuristic_use_smaller_angle``,
``constrain_transform``, ``decompose_yaw``), ``evaluation/quickscore.py``,
``utils/runs.py``, ``utils/euler.py``, ``utils/ply.py`` and
``utils/pc_util.py``. Both sides are the same float64 numpy arithmetic, so
every answer is held bit-equal."""

import json
import os

import numpy as np
import pytest

from alignnet3d_tpu import geometry as jgeo
from alignnet3d_tpu.evaluation import quickscore as jqs
from alignnet3d_tpu.utils import euler as jeuler
from alignnet3d_tpu.utils import pc_util as jpc
from alignnet3d_tpu.utils import ply as jply
from alignnet3d_tpu.utils import runs as jruns
from alignnet3d_tpu_torch import geometry as geo
from alignnet3d_tpu_torch.evaluation import quickscore as qs
from alignnet3d_tpu_torch.utils import euler, pc_util, ply, runs


def _eq(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _eq(g, r)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _transforms(rng, n):
    """Rigid 4x4 transforms: yaw-only and fully 3-D rotations."""
    out = []
    for i in range(n):
        z, y, x = rng.uniform(-np.pi, np.pi, 3)
        if i % 2:
            y = x = 0.0
        m = np.eye(4)
        m[:3, :3] = jeuler.euler2mat(z, y, x)
        m[:3, 3] = rng.normal(size=3)
        out.append(m)
    return out


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("seed", [0, 1])
def test_angle_diff_and_smaller_angle(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-10, 10, 64), rng.uniform(-10, 10, 64)
    a[:4] = [np.pi, -np.pi, 0.5 * np.pi, 1.5 * np.pi]  # the wrap edges
    _eq(geo.angle_diff(a, b), jgeo.angle_diff(a, b))
    _eq(geo.angle_diff(a[0], b[0]), jgeo.angle_diff(a[0], b[0]))
    _eq(geo.heuristic_use_smaller_angle(a), jgeo.heuristic_use_smaller_angle(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_constrain_and_decompose(seed):
    for m in _transforms(np.random.default_rng(seed), 8):
        _eq(geo.constrain_transform(m), jgeo.constrain_transform(m))
        _eq(geo.decompose_yaw(m), jgeo.decompose_yaw(m))


# ----------------------------------------------------------- quickscore

@pytest.mark.parametrize("n,accept_inverted", [(50, True), (50, False),
                                               (1200, True)])
def test_success_table(n, accept_inverted):
    """1,200 pairs reach the test subset (positions >= 1000)."""
    rng = np.random.default_rng(n)
    gt_t, gt_c = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    gt_a = rng.uniform(-np.pi, np.pi, n)
    pred_t = gt_t + 0.05 * rng.normal(size=(n, 3))
    pred_c = gt_c + 0.05 * rng.normal(size=(n, 3))
    pred_a = gt_a + np.radians(rng.normal(scale=4.0, size=n))
    pred_a[::7] += np.pi  # inverted answers
    args = (pred_t, pred_a, pred_c, gt_t, gt_a, gt_c)
    got = qs.success_table(*args, accept_inverted=accept_inverted)
    ref = jqs.success_table(*args, accept_inverted=accept_inverted)
    assert json.dumps(got) == json.dumps(ref)
    assert qs.format_table(got) == jqs.format_table(ref)
    assert qs.format_table(got, ("all",)) == jqs.format_table(ref, ("all",))


def test_quickscore_levels_and_positional_rule():
    assert qs.LEVELS == jqs.LEVELS
    for n in (0, 999, 1000, 1500):
        _eq(qs.positional_is_test(n), jqs.positional_is_test(n))


# ----------------------------------------------------------------- runs

@pytest.mark.parametrize("files,as_dir", [
    (("model-5.msgpack",), True), (("model-5.msgpack",), False),
    ((), True), (("model-4.msgpack",), False),
])
def test_resolve_run_checkpoint_like_jax(tmp_path, files, as_dir):
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text("{}")
    for f in files:
        (run / f).write_bytes(b"x")
    arg = str(run) if as_dir else str(run / "config.json")
    assert runs.resolve_run_checkpoint(arg, 5) == \
        jruns.resolve_run_checkpoint(arg, 5)


def test_resolve_run_checkpoint_finds_the_ports_pt(tmp_path):
    """The port's runs write ``.pt``: a snapshot next to the config is
    found either way (the JAX package's copy reads ``.msgpack`` only)."""
    cfg = tmp_path / "Exp.json"
    cfg.write_text("{}")
    (tmp_path / "model-7.pt").write_bytes(b"x")
    assert runs.resolve_run_checkpoint(str(cfg), 7) == (str(cfg),
                                                        str(tmp_path))
    assert jruns.resolve_run_checkpoint(str(cfg), 7) == (str(cfg), None)
    assert runs.resolve_run_checkpoint(str(cfg), 8) == (str(cfg), None)


# ---------------------------------------------------------------- euler

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_euler(seed):
    rng = np.random.default_rng(seed)
    z, y, x = rng.uniform(-np.pi, np.pi, 3)
    _eq(euler.euler2mat(z, y, x), jeuler.euler2mat(z, y, x))
    m = jeuler.euler2mat(z, y, x)
    _eq(euler.mat2euler(m), jeuler.mat2euler(m))
    q = jeuler.euler2quat(z, y, x)
    _eq(euler.euler2quat(z, y, x), q)
    _eq(euler.quat2mat(q), jeuler.quat2mat(q))
    _eq(euler.quat2euler(q), jeuler.quat2euler(q))
    _eq(euler.euler2angle_axis(z, y, x), jeuler.euler2angle_axis(z, y, x))
    axis = rng.normal(size=3)
    _eq(euler.angle_axis2euler(z, axis), jeuler.angle_axis2euler(z, axis))
    gimbal = jeuler.euler2mat(z, np.pi / 2, x)  # cos(y) = 0
    _eq(euler.mat2euler(gimbal), jeuler.mat2euler(gimbal))


# ------------------------------------------------------------------ ply

@pytest.mark.parametrize("text", [True, False])
def test_ply_files_match(tmp_path, text):
    """Each package writes the same bytes and reads the other's files."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.write_ply(pts, mine, text=text)
    jply.write_ply(pts, theirs, text=text)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    _eq(ply.read_ply_xyz(theirs), jply.read_ply_xyz(mine))
    got, ref = ply.read_ply(mine), jply.read_ply(mine)
    assert got.keys() == ref.keys()
    for k in ref:
        _eq(got[k], ref[k])


def test_ply_faces_and_extra_properties(tmp_path):
    """A file with a list property (faces) and vertex properties other
    than xyz reads the same in both packages."""
    path = str(tmp_path / "mesh.ply")
    lines = ["ply", "format ascii 1.0", "comment made by the test",
             "element vertex 3", "property float x", "property float y",
             "property float z", "property uchar red",
             "element face 1", "property list uchar int vertex_indices",
             "end_header", "0 0 0 255", "1 0 0 128", "0 1 0 7", "3 0 1 2"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    got, ref = ply.read_ply(path), jply.read_ply(path)
    assert got.keys() == ref.keys() == {"vertex", "face"}
    _eq(got["vertex"], ref["vertex"])
    # a one-property list element reads as an object array of int lists
    assert [list(f) for f in got["face"]] == [list(f) for f in ref["face"]]


# -------------------------------------------------------------- pc_util

def test_volumes():
    rng = np.random.default_rng(4)
    clouds = rng.uniform(-1.2, 1.2, size=(3, 200, 3))
    vol = jpc.point_cloud_to_volume(clouds[0], 12)
    _eq(pc_util.point_cloud_to_volume(clouds[0], 12), vol)
    for flatten in (True, False):
        _eq(pc_util.point_cloud_to_volume_batch(clouds, 8, flatten=flatten),
            jpc.point_cloud_to_volume_batch(clouds, 8, flatten=flatten))
    _eq(pc_util.volume_to_point_cloud(vol), jpc.volume_to_point_cloud(vol))


@pytest.mark.parametrize("normalize", [True, False])
def test_renders(normalize):
    pts = np.random.default_rng(5).normal(size=(60, 3)) * 0.4
    _eq(pc_util.draw_point_cloud(pts, canvasSize=120, space=60, diameter=9,
                                 zrot=0.3, normalize=normalize),
        jpc.draw_point_cloud(pts, canvasSize=120, space=60, diameter=9,
                             zrot=0.3, normalize=normalize))
    _eq(pc_util.draw_point_cloud(np.zeros((0, 3))),
        jpc.draw_point_cloud(np.zeros((0, 3))))
    _eq(pc_util.point_cloud_three_views(pts), jpc.point_cloud_three_views(pts))


def test_pc_util_uses_the_ports_own_helpers():
    assert pc_util.euler2mat is euler.euler2mat
    assert pc_util.write_ply is ply.write_ply
    assert os.path.dirname(pc_util.__file__) == os.path.dirname(euler.__file__)
