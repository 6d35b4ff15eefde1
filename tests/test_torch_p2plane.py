"""The port's point-to-plane ICP against the JAX package on the CPU: the
kNN-covariance normals, ``icp_p2plane_batch`` (normals estimated or given)
and ``refine_predictions(method="p2plane")`` on a packed synthetic dataset.

Tolerances: normals are compared by |cos| >= 1 - 1e-4 (their sign is not
part of the contract). The JAX package solves the 3x3 inverse iteration in
float32, the port in float64 (ROADMAP.md, Queue 3); a backward-stable
float32 solve tilts a normal by ~1e-7 / (eigen-gap / trace), far inside
1e-4 wherever the neighbourhood has a distinct smallest eigenvalue, as box
surfaces do. Poses: 1e-4 m / 1e-4 rad, as in tests/test_torch_icp.py.
"""

import shutil

import numpy as np
import pytest
import torch

from alignnet3d_tpu.geometry import get_mat_angle, transform_points
from alignnet3d_tpu.icp import p2plane as jpl
from alignnet3d_tpu.icp import p2point as jp2p
from alignnet3d_tpu_torch.icp import p2plane as tpl
from alignnet3d_tpu_torch.icp import p2point as tp2p
from tests.test_icp import _box_cloud, _pad
from tests.test_torch_icp import POSE_TOL, _pairs, _pose_gap

torch.set_num_threads(1)

COS_TOL = 1e-4


def _clouds(case, rng):
    if case == "boxes":
        pts, mask = _pad([_box_cloud(rng, n=n) + [3.0, -2.0, 0.5]
                          for n in (400, 260, 333)], n_max=450)
    elif case == "tilted_plane":  # valid points far from the padding zeros
        xy = rng.uniform(-1, 1, (150, 2))
        plane = np.stack([xy[:, 0] + 10, xy[:, 1] + 10,
                          5 + 0.5 * (xy[:, 0] + 10)], axis=1)
        pts, mask = _pad([plane], n_max=200)
    else:  # "few": fewer valid points than k
        pts, mask = _pad([_box_cloud(rng, n=9), _box_cloud(rng, n=40)],
                         n_max=40)
    return pts, mask


@pytest.mark.parametrize("k", [16, 10])
@pytest.mark.parametrize("case", ["boxes", "tilted_plane", "few"])
def test_normals_match_jax(case, k):
    rng = np.random.default_rng(11)
    pts, mask = _clouds(case, rng)
    want = np.asarray(jpl.estimate_normals_batch(pts, mask, k=k))
    got = tpl.estimate_normals_batch(pts, mask, k=k, device="cpu")
    assert got.dtype == torch.float32 and got.shape == pts.shape
    got = got.numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    # points with >= 3 valid neighbours: every valid point of a cloud of
    # >= 3 valid points
    keep = mask & (mask.sum(1, keepdims=True) >= 3)
    cos = np.abs(np.sum(got * want, axis=-1))[keep]
    assert cos.min() >= 1 - COS_TOL, cos.min()


def test_knn_order_is_lax_top_k_order():
    """Ascending distance, ties to the lower index, masked columns last:
    a cloud of exact duplicates makes every distance a tie."""
    pts = np.zeros((1, 12, 3), np.float32)
    pts[0, :, 0] = np.repeat([0.0, 1.0, 3.0], 4)
    mask = np.ones((1, 12), bool)
    mask[0, 5] = False
    idx, d2 = tpl._knn(torch.from_numpy(pts), torch.from_numpy(mask), 6)
    assert idx[0, 0].tolist() == [0, 1, 2, 3, 4, 6]
    assert idx[0, 4].tolist() == [4, 6, 7, 0, 1, 2]
    assert d2[0, 0].tolist() == [0, 0, 0, 0, 1, 1]
    idx, d2 = tpl._knn(torch.from_numpy(pts), torch.from_numpy(mask), 12)
    assert idx[0, 0, -1].item() == 5 and d2[0, 0, -1].item() >= 1e30


@pytest.mark.parametrize("given_normals", [False, True])
def test_icp_p2plane_matches_jax(given_normals):
    a, am, d, dm, init = _pairs(12)
    normals = (np.asarray(jpl.estimate_normals_batch(d, dm, k=16))
               if given_normals else None)
    want = jpl.icp_p2plane_batch(a, am, d, dm, init, radius=0.5, its=10,
                                 dst_normals=normals)
    got = tpl.icp_p2plane_batch(a, am, d, dm, init, radius=0.5, its=10,
                                dst_normals=normals, device="cpu")
    dt, dr = _pose_gap(got[0], want[0])
    assert dt <= POSE_TOL and dr <= POSE_TOL, (dt, dr)
    np.testing.assert_allclose(got[0][:, 2, :2], 0.0, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], atol=1.0 / 300)


def test_icp_p2plane_trust_region_matches_jax():
    """A start 0.5 rad and 3 m off: the per-iteration clip of theta (0.3)
    and of |t| (1 m) shape the path, in both packages alike."""
    rng = np.random.default_rng(13)
    src = _box_cloud(rng, n=300) + np.array([5.0, 3.0, 0.0])
    dst = transform_points(src, get_mat_angle([0.2, 0.1, 0.0], 0.05))
    (a, am), (d, dm) = _pad([src]), _pad([dst])
    init = get_mat_angle([3.0, -1.0, 0.0], 0.5)[None]
    want = jpl.icp_p2plane_batch(a, am, d, dm, init, radius=5.0, its=3)
    got = tpl.icp_p2plane_batch(a, am, d, dm, init, radius=5.0, its=3,
                                device="cpu")
    dt, dr = _pose_gap(got[0], want[0])
    assert dt <= POSE_TOL and dr <= POSE_TOL, (dt, dr)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """One synthetic dataset, a copy for each package (both write packed
    caches next to it)."""
    from alignnet3d_tpu.data.provider import PackedDataset as JaxPacked
    from alignnet3d_tpu_torch.data.provider import PackedDataset
    from alignnet3d_tpu_torch.data.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("p2plane_data")
    generate_dataset(str(root / "port"), num_train=2, num_val=5, seed=3,
                     vres=16, hres=180)
    shutil.copytree(root / "port", root / "jax")
    return JaxPacked(str(root / "jax")), PackedDataset(str(root / "port"))


def test_normals_of_scans_match_jax(packed):
    """Normals of the dataset's LiDAR clouds (scan lines: elongated
    neighbourhoods), padded as refine_predictions pads them."""
    _, tds = packed
    _, (dst, dst_mask) = tp2p.pad_full_clouds(tds, list(range(2, 7)))
    want = np.asarray(jpl.estimate_normals_batch(dst, dst_mask, k=16))
    got = tpl.estimate_normals_batch(dst, dst_mask, k=16,
                                     device="cpu").numpy()
    cos = np.abs(np.sum(got * want, axis=-1))[dst_mask]
    assert cos.min() >= 1 - COS_TOL, cos.min()


@pytest.mark.parametrize("method", ["p2plane", "p2p"])
def test_refine_predictions_on_a_dataset_matches_jax(packed, method):
    """Gated, as the eval stack runs it. Without the gate some raw scan
    pairs diverge from a good init (tests/test_p2plane.py says so of the
    JAX package alone); a diverging path amplifies the float32 / float64
    gap of the pose algebra, so the ungated comparison is made on the box
    oracles of tests/test_torch_icp.py instead."""
    jds, tds = packed
    val = list(range(2, 7))
    rows = tds.rows(val)
    rng = np.random.default_rng(14)
    gt_t = tds.translations[rows].reshape(-1, 3)
    pred_t = (gt_t + rng.normal(0, 0.05, gt_t.shape) * [1, 1, 0]).astype(
        np.float32)
    pred_a = (tds.rel_angles[rows].reshape(-1, 1)
              + rng.normal(0, 0.03, (len(val), 1))).astype(np.float32)
    pred_c = tds.pc1centers[rows].reshape(-1, 3).astype(np.float32)
    kwargs = dict(its=25, radius=0.3, method=method, gate=True,
                  gate_max_dyaw_deg=2.0, gate_max_dxy=0.15, pair_chunk=4)
    want, _ = jp2p.refine_predictions(None, val, pred_t, pred_a, pred_c,
                                      dataset=jds, **kwargs)
    got, _ = tp2p.refine_predictions(None, val, pred_t, pred_a, pred_c,
                                     dataset=tds, device="cpu", **kwargs)
    np.testing.assert_allclose(got["translations"], want["translations"],
                               atol=POSE_TOL)
    dang = np.mod(got["angles"] - want["angles"] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dang).max() <= POSE_TOL
    assert np.all(np.isfinite(got["translations"]))
