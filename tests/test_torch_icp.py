"""The port's point-to-point ICP against the JAX package on the CPU:
``icp_p2point_batch`` with and without the ground-plane constraint,
``multistart_global_registration``, ``pad_full_clouds`` and
``refine_predictions`` with the gate off and on. The same numpy-seeded
box clouds and inits go through both.

Tolerances: the JAX package runs the pose algebra in float32, the port in
float64 (ROADMAP.md, Queue 3), so poses agree to the float32 rounding of
the JAX side carried through the iterations; from near-truth inits the
iteration contracts, and 1e-4 m / 1e-4 rad bounds that with a wide margin.
"""

import numpy as np
import pytest
import torch

from alignnet3d_tpu.geometry import get_mat_angle as jax_get_mat_angle
from alignnet3d_tpu.geometry import transform_points
from alignnet3d_tpu.icp import p2point as jp2p
from alignnet3d_tpu_torch.icp import p2point as tp2p
from tests.test_icp import _FakePacked, _box_cloud, _pad

torch.set_num_threads(1)

POSE_TOL = 1e-4   # m and rad, per pair; see the module docstring


def _rot_z(tf):
    return np.arctan2(tf[:, 1, 0], tf[:, 0, 0])


def _pose_gap(a, b):
    """(max translation gap m, max rotation gap rad) over the batch; the
    rotation gap is the largest entry of R_a - R_b."""
    dt = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
    dr = np.abs(a[:, :3, :3] - b[:, :3, :3]).max()
    return dt, dr


def _pairs(seed, b=4, n=300, tilt=0.0):
    """b box-surface pairs with known small motions (yaw, translation and,
    with ``tilt``, a roll about x), and near-truth inits."""
    rng = np.random.default_rng(seed)
    srcs, dsts, inits = [], [], []
    for i in range(b):
        src = _box_cloud(rng, n=n + 37 * i) + np.array([5.0, 3.0, 0.0])
        M = jax_get_mat_angle(rng.uniform(-0.3, 0.3, 3) * [1, 1, 0.2],
                              rng.uniform(-0.15, 0.15))
        c, s = np.cos(tilt), np.sin(tilt)
        M[:3, :3] = M[:3, :3] @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        dsts.append(transform_points(src, M))
        srcs.append(src)
        init = jax_get_mat_angle(M[:3, 3] + rng.normal(0, 0.02, 3) * [1, 1, 0],
                                 np.arctan2(M[1, 0], M[0, 0])
                                 + rng.normal(0, 0.01))
        inits.append(init)
    (a, am), (d, dm) = _pad(srcs), _pad(dsts)
    return a, am, d, dm, np.stack(inits)


@pytest.mark.parametrize("constrained", [True, False])
def test_icp_p2point_matches_jax(constrained):
    a, am, d, dm, init = _pairs(1, tilt=0.0 if constrained else 0.05)
    want = jp2p.icp_p2point_batch(a, am, d, dm, init, radius=0.5, its=10,
                                  with_constraint=constrained)
    got = tp2p.icp_p2point_batch(a, am, d, dm, init, radius=0.5, its=10,
                                 with_constraint=constrained, device="cpu")
    dt, dr = _pose_gap(got[0], want[0])
    assert dt <= POSE_TOL and dr <= POSE_TOL, (dt, dr)
    if constrained:
        np.testing.assert_allclose(got[0][:, 2, :2], 0.0, atol=1e-12)
    else:  # the roll is recovered, a proper rotation
        assert np.abs(got[0][:, 2, 1]).max() > 0.01
        np.testing.assert_allclose(np.linalg.det(got[0][:, :3, :3]), 1.0,
                                   atol=1e-9)
    # the fitness counts points inside the radius: one point of the
    # smallest cloud may cross it by rounding. At convergence the squared
    # distances are rounding noise of the float32 expansion |a|^2 - 2ab +
    # |b|^2 at |a|^2 ~ 40 m^2 (ulp 3.8e-6), so the mean squared inlier
    # distance is held to 3e-5 m^2
    np.testing.assert_allclose(got[1], want[1], atol=1.0 / 300)
    np.testing.assert_allclose(got[2] ** 2, want[2] ** 2, atol=3e-5)


@pytest.mark.parametrize("seed,its,radius", [(1, 10, 0.5), (5, 30, 0.1),
                                              (9, 1, 0.05)])
def test_constrained_icp_is_bit_equal_to_the_eager_loop(seed, its, radius):
    """On the CPU the constrained loop (a sweep and ``icp_update``, whose
    plain version runs here) gives what the eager loop with the closed-form
    callback gave, bit for bit: transforms, fitness and RMSE."""
    a, am, d, dm, init = _pairs(seed)

    def estimate(moved, idx, w, dst64):
        return tp2p._estimate_yaw_translation(
            moved, tp2p.gather_points(dst64, idx), w)

    got = tp2p.icp_p2point_batch(a, am, d, dm, init, radius=radius, its=its,
                                 device="cpu")
    want = tp2p.run_icp(a, am, d, dm, init, radius, its, estimate,
                        device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_icp_p2point_padding_and_no_correspondence_match_jax():
    """Poisoned padding changes nothing, and a pair with no point inside
    the radius keeps its init with fitness 0, as in the JAX package."""
    rng = np.random.default_rng(2)
    src = _box_cloud(rng, n=200)
    near = transform_points(src, jax_get_mat_angle([0.1, -0.05, 0.0], 0.05))
    far = src + np.array([100.0, 0.0, 0.0])
    a, am = _pad([src, src], n_max=256)
    d, dm = _pad([near, far], n_max=256)
    a[:, 200:] = 1e3
    d[:, 200:] = -1e3
    init = np.stack([np.eye(4), jax_get_mat_angle([1.0, 2.0, 0.0], 0.3)])
    want = jp2p.icp_p2point_batch(a, am, d, dm, init, radius=0.5, its=15)
    got = tp2p.icp_p2point_batch(a, am, d, dm, init, radius=0.5, its=15,
                                 device="cpu")
    dt, dr = _pose_gap(got[0], want[0])
    assert dt <= POSE_TOL and dr <= POSE_TOL, (dt, dr)
    np.testing.assert_allclose(got[0][1], init[1], atol=1e-12)
    assert got[1][1] == want[1][1] == 0.0


def test_multistart_matches_jax_at_a_large_yaw():
    rng = np.random.default_rng(3)
    srcs, dsts, gts = [], [], []
    for yaw in (2.1, -1.7):
        src = _box_cloud(rng, n=300) + np.array([4.0, 2.0, 0.0])
        M = jax_get_mat_angle(np.array([0.4, -0.2, 0.0]), yaw)
        srcs.append(src)
        dsts.append(transform_points(src, M))
        gts.append(M)
    (a, am), (d, dm) = _pad(srcs), _pad(dsts)
    want = jp2p.multistart_global_registration(a, am, d, dm)
    got = tp2p.multistart_global_registration(a, am, d, dm, device="cpu")
    dt, dr = _pose_gap(got[0], want[0])
    assert dt <= POSE_TOL and dr <= POSE_TOL, (dt, dr)
    for i, M in enumerate(gts):  # and both found the true motion
        err = np.abs(transform_points(srcs[i], got[0][i]) - dsts[i]).max()
        assert err < 0.05, err
    assert np.all(got[1] > 0.95)


def test_pad_full_clouds_is_bit_equal():
    rng = np.random.default_rng(4)
    clouds1 = [_box_cloud(rng, n=n) for n in (50, 400, 120)]
    clouds2 = [_box_cloud(rng, n=n) for n in (90, 30, 500)]
    ds = _FakePacked(clouds1, clouds2)
    for kwargs in ({"max_points": 256}, {"max_points": 256, "pad_to": 300},
                   {"max_points": 4096}):
        got = tp2p.pad_full_clouds(ds, [2, 0, 1], seed=5, **kwargs)
        want = jp2p.pad_full_clouds(ds, [2, 0, 1], seed=5, **kwargs)
        for g, w in zip(got, want):
            for ga, wa in zip(g, w):
                assert ga.dtype == wa.dtype
                np.testing.assert_array_equal(ga, wa)


def refine_case(seed, b=8):
    """A duck-typed dataset of b box pairs and network-like predictions
    about a nonzero rotation centre: half near the truth, half 8 degrees
    off, so that a 2-degree gate rejects the ICP moves of those."""
    rng = np.random.default_rng(seed)
    clouds1, clouds2, pred_t, pred_a, pred_c = [], [], [], [], []
    for i in range(b):
        src = _box_cloud(rng, n=250 + 20 * i) + np.array([6.0, 2.0, 0.0])
        yaw = rng.uniform(-1.0, 1.0)
        t = rng.uniform(-0.5, 0.5, 3) * np.array([1, 1, 0.1])
        c = src.mean(axis=0)
        clouds1.append(src)
        clouds2.append(transform_points(src, jax_get_mat_angle(t, yaw, c)))
        off = np.deg2rad(8.0) if i % 2 else rng.normal(0, 0.01)
        pred_t.append(t + rng.normal(0, 0.03, 3) * [1, 1, 0])
        pred_a.append([yaw + off])
        pred_c.append(c)
    return (_FakePacked(clouds1, clouds2), np.asarray(pred_t, np.float32),
            np.asarray(pred_a, np.float32), np.asarray(pred_c, np.float32))


def jax_accept_mask(gated, ungated, init_t, init_a):
    """The JAX gate's per-pair decision, read off its answers: a pair took
    either the ungated ICP answer or its init (which differ on every pair
    of the case, checked here)."""
    def same(out, t, a, tol=1e-5):
        return (np.abs(out["translations"] - t).max(axis=1) < tol) & (
            np.abs(out["angles"][:, 0] - a) < tol)

    took_icp = same(gated, ungated["translations"], ungated["angles"][:, 0])
    took_init = same(gated, init_t, init_a)
    assert not np.any(same(ungated, init_t, init_a))
    assert np.all(took_icp ^ took_init)
    return took_icp


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("method", ["p2p", "p2plane"])
def test_refine_predictions_matches_jax(gate, method):
    ds, pred_t, pred_a, pred_c = refine_case(6)
    idxs = list(range(len(pred_t)))
    kwargs = dict(its=15, radius=0.3, dataset=ds, pair_chunk=3,
                  method=method, gate=gate, gate_max_dyaw_deg=2.0,
                  gate_max_dxy=0.15)
    want, _ = jp2p.refine_predictions(None, idxs, pred_t, pred_a, pred_c,
                                      **kwargs)
    got, elapsed = tp2p.refine_predictions(None, idxs, pred_t, pred_a,
                                           pred_c, device="cpu", **kwargs)
    assert elapsed > 0
    assert got["translations"].dtype == np.float32
    assert got["angles"].shape == (len(idxs), 1)
    np.testing.assert_allclose(got["translations"], want["translations"],
                               atol=POSE_TOL)
    dang = np.mod(got["angles"] - want["angles"] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dang).max() <= POSE_TOL
    if not gate:
        assert got["accepted"].all()
        return
    ungated, _ = jp2p.refine_predictions(None, idxs, pred_t, pred_a, pred_c,
                                         **dict(kwargs, gate=False))
    init = np.stack([jax_get_mat_angle(pred_t[i], pred_a[i], pred_c[i])
                     for i in idxs])
    mask = jax_accept_mask(want, ungated, init[:, :3, 3].astype(np.float32),
                           _rot_z(init).astype(np.float32))
    np.testing.assert_array_equal(got["accepted"], mask)
    # the case exercises both decisions: the 8-degree pairs are rejected
    assert mask.any() and not mask.all()
    assert not mask[1::2].any()


def test_refine_predictions_rejects_an_unknown_method():
    ds, pred_t, pred_a, pred_c = refine_case(7, b=2)
    with pytest.raises(ValueError, match="method"):
        tp2p.refine_predictions(None, [0, 1], pred_t, pred_a, pred_c,
                                dataset=ds, method="p2line", device="cpu")


def test_icp_entry_points_need_a_device():
    a, am, d, dm, init = _pairs(8, b=1)
    with pytest.raises(TypeError):
        tp2p.icp_p2point_batch(a, am, d, dm, init)
    with pytest.raises(TypeError):
        tp2p.multistart_global_registration(a, am, d, dm)
