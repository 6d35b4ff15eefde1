"""The port's own copies of the JAX package's numpy host code give exactly
the JAX modules' output on the same inputs: config, geometry, the input
filters and the synthetic scene generator."""

import os

import numpy as np
import pytest

from alignnet3d_tpu import config as jcfg
from alignnet3d_tpu import geometry as jgeo
from alignnet3d_tpu.data import denoise as jden
from alignnet3d_tpu.data import provider as jprov
from alignnet3d_tpu.data import synthetic as jsyn
from alignnet3d_tpu_torch import config as tcfg
from alignnet3d_tpu_torch import geometry as tgeo
from alignnet3d_tpu_torch.data import denoise as tden
from alignnet3d_tpu_torch.data import provider as tprov
from alignnet3d_tpu_torch.data import synthetic as tsyn

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _tree(ns):
    return {k: _tree(v) if hasattr(v, "has") else v
            for k, v in vars(ns).items()}


@pytest.mark.parametrize("name", ["SynthCars40kDGCNN.json", "SynthCars.json"])
def test_config_from_dict_matches(name):
    import json

    with open(os.path.join(CONFIGS, name)) as f:
        d = json.load(f)
    assert _tree(tcfg.config_from_dict(d)) == _tree(jcfg.config_from_dict(d))


def test_load_config_matches():
    path = os.path.join(CONFIGS, "SynthCars40kDGCNN.json")
    got = _tree(tcfg.load_config(path))
    assert got == _tree(jcfg.load_config(path))
    assert got["name"] == "SynthCars40kDGCNN"
    assert got["model"]["backbone"] == "dgcnn"


def test_namespace_has_and_get():
    ns = tcfg.config_from_dict({"model": {"extra": 3}})
    assert ns.model.has("extra") and not ns.model.has("missing")
    assert ns.model.get("missing", 7) == 7
    assert repr(ns).startswith("config:")


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.uniform(-np.pi, np.pi, n),
            rng.normal(size=(n, 3)))


@pytest.mark.parametrize("fn", ["rotation_matrix_z", "get_mat_angle",
                                "get_mat_angle_batch", "transform_points",
                                "compose_gated_refinement"])
def test_geometry_matches(fn):
    t, a, c = _poses(0, 6)
    if fn == "rotation_matrix_z":
        args = [(a,), (a[0],)]
    elif fn == "get_mat_angle":
        args = [(t[0], a[0], c[0]), (t[1], a[1]), (None, None)]
    elif fn == "get_mat_angle_batch":
        args = [(t, a, c)]
    elif fn == "transform_points":
        args = [(np.random.default_rng(1).normal(size=(50, 3)),
                 jgeo.get_mat_angle(t[0], a[0], c[0]))]
    else:
        t2, a2, c2 = _poses(2, 6)
        a2 = a2 * 0.1  # some inside the gate, some outside
        args = [(jgeo.get_mat_angle_batch(t, a, c), t2 * 0.3, a2, c2,
                 2.0, 0.15)]
    for arg in args:
        got, ref = getattr(tgeo, fn)(*arg), getattr(jgeo, fn)(*arg)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(g, r)


def _hard_clouds():
    """Clouds with clutter (hard scenes leak an occluder's returns)."""
    clouds = []
    for seed in range(12):
        scene = jsyn.SyntheticBoxScene(seed, vres=16, hres=360, hard=True)
        scene.generate_pointcloud()
        clouds += [pc for pc in scene.pointclouds if len(pc)]
    return clouds


@pytest.mark.parametrize("keep", ["central", "largest"])
def test_component_filter_indices_matches(keep):
    clouds = _hard_clouds()
    flat = np.concatenate(clouds)
    cid = np.repeat(np.arange(len(clouds)), [len(c) for c in clouds])
    ref = jden.component_filter_indices(flat, cid, 0.5, keep)
    got = tden.component_filter_indices(flat, cid, 0.5, keep)
    assert len(ref) < len(flat)  # the filter removed something
    np.testing.assert_array_equal(got, ref)


def test_voxel_dedup_indices_matches():
    clouds = _hard_clouds()
    flat = np.concatenate(clouds)
    cid = np.repeat(np.arange(len(clouds)), [len(c) for c in clouds])
    ref = jprov.voxel_dedup_indices(flat, cid, 0.1)
    np.testing.assert_array_equal(tprov.voxel_dedup_indices(flat, cid, 0.1),
                                  ref)
    assert len(ref) < len(flat)


@pytest.mark.parametrize("kwargs", [
    {},
    {"hard": True},
    {"allow_persons": True, "person_prob": 0.9, "second_object_set": True},
])
def test_synthetic_scene_clouds_match(kwargs):
    for seed in range(6):
        ref = jsyn.SyntheticBoxScene(seed, vres=16, hres=180, **kwargs)
        got = tsyn.SyntheticBoxScene(seed, vres=16, hres=180, **kwargs)
        ref.generate_pointcloud()
        got.generate_pointcloud()
        assert got.additional_meta == ref.additional_meta
        for g, r in zip(got.pointclouds, ref.pointclouds):
            assert g.dtype == r.dtype == np.float32
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got.transform.transform_end,
                                      ref.transform.transform_end)
