"""The port's FPFH + RANSAC global registration against the JAX package on
the CPU: the same numpy-seeded clouds go through ``alignnet3d_tpu.icp.fpfh``
and ``alignnet3d_tpu_torch.icp.fpfh``.

Tolerances:
- ``voxel_downsample`` and ``prep_downsampled_batch`` are host numpy in
  both packages: bit-equal.
- Normals: |cos| >= 1 - 1e-4 wherever the smallest eigenvalue of the
  neighbourhood covariance is apart from the next one (eigengap
  (l1 - l0) / l2 >= EIGENGAP); below it the eigenvector is arbitrary.
- FPFH bins are percentages in [0, 100] of a truncated bin position: the
  JAX package computes in float32, the port in float64, so a value within
  rounding of a bin edge may land in the next bin. Within 1e-3 on >= 99%
  of the points.
- Feature matches: the port's are the exact (float64) nearest neighbours
  on every valid row. The JAX package's float32 expansion
  |a|^2 - 2 a.b + |b|^2 rounds at the scale of |a|^2 + |b|^2, which for
  FPFH descriptors reaches ~3e6 (ulp 0.25) while the best squared
  distances are ~0.01-10: its matches are held equal where the best beats
  the second by more than MATCH_MARGIN = 1e-6 of |a|^2 + |b|^2 (16 float32
  ulps), the gap it resolves.
- RANSAC with the JAX package's own draws injected (``jax.random.choice``
  on the same split keys), on L-cloud pairs whose descriptors decide every
  match by far more than that (60% true matches with 1 cm of noise on the
  points, 40% wrong ones): the same winning hypothesis, so R and t agree
  to the float32 rounding of a 4-point estimate, 1e-5; fitness equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu.geometry import get_mat_angle, transform_points
from alignnet3d_tpu.icp import fpfh as jf
from alignnet3d_tpu.icp.p2point import icp_p2point_batch as jax_icp
from alignnet3d_tpu_torch.icp import fpfh as tf
from alignnet3d_tpu_torch.icp.p2point import icp_p2point_batch
from tests.test_fpfh import _L_cloud

torch.set_num_threads(1)

EIGENGAP = 1e-3
POSE_TOL = 1e-5
MATCH_MARGIN = 1e-6


def _padded(cloud, n):
    """A downsampled cloud padded with zeros to n points, and its mask."""
    pts = np.zeros((n, 3), np.float32)
    pts[:len(cloud)] = cloud[:n]
    return pts, np.arange(n) < len(cloud)


def _down(cloud, n, voxel=0.05):
    return _padded(jf.voxel_downsample(cloud, voxel, max_points=n), n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pair(seed, yaw=2.4, n=400, offset=(3.0, 1.0, 0.0), t=(0.5, -0.3, 0.0)):
    rng = np.random.default_rng(seed)
    src = _L_cloud(rng, n=n) + np.array(offset, np.float32)
    dst = transform_points(src, get_mat_angle(list(t), yaw)).astype(
        np.float32)
    return src, dst


@pytest.mark.parametrize("max_points", [None, 64])
def test_voxel_downsample_is_bit_equal(max_points):
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(3000, 3)) * [2.0, 1.0, 0.5]).astype(np.float32)
    got = tf.voxel_downsample(pts, 0.1, max_points=max_points)
    want = jf.voxel_downsample(pts, 0.1, max_points=max_points)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if max_points:
        assert len(got) == max_points
    clouds = np.stack([pts[:1000], pts[1000:2000]])
    masks = np.ones(clouds.shape[:2], bool)
    masks[1, 700:] = False
    for g, w in zip(tf.prep_downsampled_batch(clouds, masks, 0.1, 128),
                    jf.prep_downsampled_batch(clouds, masks, 0.1, 128)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _eigengap(points, mask, k=16):
    """Per point (l1 - l0) / l2 of the k-neighbourhood covariance, from the
    port's neighbours, in numpy float64."""
    idx = tf._knn(*_t(points[None], mask[None]), k)[0][0].numpy()
    neigh = points.astype(np.float64)[idx]
    c = neigh - neigh.mean(axis=1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c) / k)
    return (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-300)


@pytest.mark.parametrize("spread", [(1.0, 1.0, 1.0), (1.0, 0.5, 1e-3),
                                    (1.0, 0.5, 1e-8), (1.0, 1e-4, 1e-4)])
def test_smallest_eigenvector_matches_eigh(spread):
    """The closed-form eigenvector against LAPACK's ``eigh`` on covariances
    of 16 points of rotated anisotropic spreads: |cos| >= 1 - 1e-12 where
    the eigengap is >= EIGENGAP; elsewhere (a double smallest eigenvalue)
    still a unit eigenvector."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(2000, 16, 3)) * spread
    q, _ = np.linalg.qr(rng.normal(size=(2000, 3, 3)))
    c = np.einsum("nij,nkj->nki", q, pts - pts.mean(1, keepdims=True))
    cov = np.einsum("nki,nkj->nij", c, c) / 16
    w, v = np.linalg.eigh(cov)
    got = tf._smallest_eigenvector(torch.from_numpy(cov)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)
    gap = (w[:, 1] - w[:, 0]) / w[:, 2]
    held = gap >= EIGENGAP
    assert np.all(np.abs(np.sum(got * v[:, :, 0], axis=1))[held]
                  >= 1 - 1e-12)
    resid = np.linalg.norm(np.einsum("nij,nj->ni", cov, got)
                           - w[:, :1] * got, axis=1) / w[:, 2]
    assert resid.max() < 1e-6
    # degenerate matrices: zero, a multiple of I, a line
    line = np.zeros((3, 3))
    line[0, 0] = 1.0
    for m in (np.zeros((3, 3)), 2.0 * np.eye(3), line):
        e = tf._smallest_eigenvector(torch.from_numpy(m)).numpy()
        lam = np.linalg.eigvalsh(m)[0]
        np.testing.assert_allclose(m @ e, lam * e, atol=1e-12)
        assert abs(np.linalg.norm(e) - 1) < 1e-12


@pytest.mark.parametrize("case", ["L", "plane_far"])
def test_normals_match_jax(case):
    rng = np.random.default_rng(1)
    if case == "L":
        cloud = _L_cloud(rng, n=500) + np.array([3.0, 1.0, 0.0], np.float32)
    else:
        cloud = np.stack([rng.uniform(-1, 1, 400), rng.uniform(-1, 1, 400),
                          np.full(400, 6.0)], axis=1).astype(np.float32)
    pts, mask = _down(cloud, 512)
    want = np.asarray(jf.estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    got = tf.estimate_normals(*_t(pts[None], mask[None]))[0].numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)
    held = mask & (_eigengap(pts, mask) >= EIGENGAP)
    assert held.sum() >= 0.9 * mask.sum()
    cos = np.sum(got * want, axis=1)
    # and oriented alike, toward the origin
    assert np.all(cos[held] >= 1 - 1e-4), np.sort(cos[held])[:5]


@pytest.mark.parametrize("case", ["L", "L_far", "sparse"])
def test_fpfh_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "sparse":
        # fewer valid points than k = 32 (and than the normals' 16): the
        # neighbourhoods fill up with padded points at the origin, which
        # lies in the patch's plane, so that the normals stay defined
        cloud = np.zeros((12, 3), np.float32)
        cloud[:, :2] = rng.uniform(0, 0.4, (12, 2)) + [4.0, 1.0]
        pts, mask = _padded(cloud, 64)
        radius = 0.5
    else:
        offset = [3.0, 1.0, 0.0] if case == "L" else [8.0, -5.0, 0.5]
        cloud = _L_cloud(rng, n=500) + np.array(offset, np.float32)
        pts, mask = _down(cloud, 512)
        radius = 0.25
    fj, nj = jf.fpfh_features(jnp.asarray(pts), jnp.asarray(mask), radius)
    ft, nt = tf.fpfh_features(*_t(pts, mask), radius)
    fj, ft = np.asarray(fj)[mask], ft.numpy()[mask]
    assert ft.shape == fj.shape and np.isfinite(ft).all()
    close = np.abs(ft - fj).max(axis=1) <= 1e-3
    if case == "sparse":
        assert close.all(), np.abs(ft - fj).max()
    else:
        assert close.mean() >= 0.99, close.mean()
    # the descriptor's three histograms each sum to 100% (or 0 when a
    # point has no neighbour within the radius), plus the weighted average
    assert np.all(ft >= 0)


def test_knn_padded_neighbours_gather_the_same_points():
    """With fewer valid points than k, the port's neighbour lists end in
    padded columns at 1e30 + d2 where the JAX package's sit at +inf; the
    gathered coordinates and masks are the same."""
    rng = np.random.default_rng(3)
    pts, mask = _padded(rng.uniform(0, 1, (10, 3)).astype(np.float32), 40)
    idx_j, _ = jf._knn_indices(jnp.asarray(pts), jnp.asarray(mask), 32)
    idx_t = tf._knn(*_t(pts[None], mask[None]), 32)[0][0].numpy()
    idx_j = np.asarray(idx_j)
    np.testing.assert_array_equal(pts[idx_t], pts[idx_j])
    np.testing.assert_array_equal(mask[idx_t], mask[idx_j])
    assert np.array_equal(idx_t[:, :10], idx_j[:, :10])


def _features(seed, kind, n=300):
    rng = np.random.default_rng(seed)
    if kind == "random":
        fs = np.abs(rng.normal(size=(n, 33)) * 20).astype(np.float32)
        fd = np.abs(rng.normal(size=(n, 33)) * 20).astype(np.float32)
        ms, md = rng.uniform(size=n) < 0.9, rng.uniform(size=n) < 0.85
        return fs, ms, fd, md
    src, dst = _pair(seed)
    (sp, ms), (dp, md) = _down(src, 384), _down(dst, 384)
    fs = np.asarray(jf.fpfh_features(jnp.asarray(sp), jnp.asarray(ms),
                                     0.25)[0])
    fd = np.asarray(jf.fpfh_features(jnp.asarray(dp), jnp.asarray(md),
                                     0.25)[0])
    return fs, ms, fd, md


def _exact_matches(fs, fd, md, margin=MATCH_MARGIN):
    """The exact nearest valid dst row of each src row (float64, ties to
    the lower index), and whether it beats the second by more than
    ``margin`` (|a|^2 + |b|^2)."""
    a, b = fs.astype(np.float64), fd.astype(np.float64)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    d2[:, ~md] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")[:, :2]
    two = np.take_along_axis(d2, order, axis=1)
    scale = (a ** 2).sum(1) + (b ** 2).sum(1)[order].max(1)
    return order[:, 0], (two[:, 1] - two[:, 0]) > margin * scale


@pytest.mark.parametrize("kind", ["random", "fpfh"])
def test_feature_correspondences_match_jax(kind):
    fs, ms, fd, md = _features(4, kind)
    want = np.asarray(jf._feature_correspondences(
        *(jnp.asarray(x) for x in (fs, ms, fd, md))))
    got = tf._feature_correspondences(*_t(fs[None], ms[None], fd[None],
                                          md[None]))[0].numpy()
    exact, decided = _exact_matches(fs, fd, md)
    np.testing.assert_array_equal(got[ms], exact[ms])
    held = ms & decided
    assert held.sum() >= 0.5 * ms.sum()
    np.testing.assert_array_equal(got[held], want[held])


def _jax_corr_valid(sf, sm, df, dm, mutual_filter, ransac_n=4):
    """The JAX package's RANSAC correspondence set (fpfh.py:180-189)."""
    corr = jf._feature_correspondences(sf, sm, df, dm)
    corr_valid = sm & dm[corr]
    if mutual_filter:
        bwd = jf._feature_correspondences(df, dm, sf, sm)
        mutual_valid = corr_valid & (bwd[corr] == jnp.arange(sf.shape[0]))
        corr_valid = jnp.where(jnp.sum(mutual_valid) >= ransac_n,
                               mutual_valid, corr_valid)
    return corr_valid


def _jax_picks(key, corr_valid, num_hypotheses, ransac_n=4):
    """The draws of ``jf.ransac_registration``: one key per hypothesis."""
    keys = jax.random.split(key, num_hypotheses)
    n = corr_valid.shape[0]
    p = corr_valid / jnp.sum(corr_valid)
    return np.array(jax.jit(jax.vmap(lambda k: jax.random.choice(
        k, n, (ransac_n,), replace=False, p=p)))(keys))


def _ransac_inputs(seed, n=288, yaw=2.4, noise=0.01, wrong=0.4):
    """An L-cloud pair at a 137 degree yaw (1 cm of noise on dst), padded
    to 320 points, and descriptors that decide every match by far more than
    the float32 rounding: dst row i copies src row i (with noise) for 60%
    of the rows and is a fresh random descriptor for the rest."""
    rng = np.random.default_rng(seed)
    src, dst = _pair(seed, yaw=yaw, n=n)
    dst = (dst + rng.normal(0, noise, dst.shape)).astype(np.float32)
    sf = rng.uniform(0, 100, (n, 33)).astype(np.float32)
    df = (sf + rng.normal(0, 0.5, sf.shape)).astype(np.float32)
    bad = rng.uniform(size=n) < wrong
    df[bad] = rng.uniform(0, 100, (bad.sum(), 33))
    (sp, sm), (dp, dm) = _padded(src, 320), _padded(dst, 320)
    sf, df = (np.pad(f, ((0, 320 - n), (0, 0))) for f in (sf, df))
    return tuple(jnp.asarray(x) for x in (sp, sm, dp, dm, sf, df))


@pytest.mark.parametrize("constrained,mutual,k", [
    (True, True, 512), (True, False, 256), (False, True, 512)])
def test_ransac_with_jax_draws_matches_jax(constrained, mutual, k):
    """The same features and the JAX package's own picks: the port picks the
    same hypothesis and agrees on the transform and its scores."""
    inputs = _ransac_inputs(5)
    key = jax.random.PRNGKey(7)
    R_j, t_j, fit_j, rmse_j = jf.ransac_registration(
        *inputs, key, 0.075, num_hypotheses=k, with_constraint=constrained,
        mutual_filter=mutual)
    sp, sm, dp, dm, sf, df = inputs
    picks = _jax_picks(key, _jax_corr_valid(sf, sm, df, dm, mutual), k)
    R, t, fit, rmse = tf.ransac_registration(
        *_t(*inputs), 0.075, num_hypotheses=k, with_constraint=constrained,
        mutual_filter=mutual, picks=picks)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=POSE_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=POSE_TOL)
    # the same inlier count over the same match set (the JAX package's
    # ratio is float32)
    assert np.float32(float(fit)) == np.float32(fit_j)
    assert float(rmse) == pytest.approx(float(rmse_j), abs=1e-5)
    if constrained:
        np.testing.assert_allclose(R.numpy()[2], [0, 0, 1], atol=1e-12)
    assert float(fit) > 0.5   # the 137 degree motion was found


def test_ransac_mutual_filter_fallback_matches_jax(rng):
    """Identical descriptors leave (almost) no reciprocal match: both
    packages fall back to the unpruned set and stay finite."""
    n = 64
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    msk = np.ones(n, bool)
    flat = np.ones((n, 33), np.float32)
    key = jax.random.PRNGKey(1)
    j_in = [jnp.asarray(x) for x in (pts, msk, pts, msk, flat, flat)]
    R_j, t_j, fit_j, _ = jf.ransac_registration(
        *j_in, key, 0.075, num_hypotheses=64, mutual_filter=True)
    corr_valid = _jax_corr_valid(j_in[4], j_in[1], j_in[5], j_in[3], True)
    assert int(jnp.sum(corr_valid)) == n  # the fallback: all n matches
    picks = _jax_picks(key, corr_valid, 64)
    R, t, fit, _ = tf.ransac_registration(
        *_t(pts, msk, pts, msk, flat, flat), 0.075, num_hypotheses=64,
        mutual_filter=True, picks=picks)
    assert np.isfinite(R.numpy()).all() and np.isfinite(t.numpy()).all()
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=POSE_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=POSE_TOL)
    assert np.float32(float(fit)) == np.float32(fit_j)
    # and with the port's own draws
    R, t, _, _ = tf.ransac_registration(
        *_t(pts, msk, pts, msk, flat, flat), 0.075, num_hypotheses=64)
    assert np.isfinite(R.numpy()).all() and np.isfinite(t.numpy()).all()


@pytest.mark.parametrize("k", [2049, 3000, 4096])
def test_hypothesis_chunks_equal_one_chunk(k, monkeypatch):
    """K > 2,048 hypotheses are scored in chunks; the first of the best
    wins across chunks exactly as in one flat pass, odd K included, and as
    in the JAX package (which pads K up to a chunk multiple with copies of
    its first hypotheses) with its draws injected."""
    inputs = _ransac_inputs(8)
    key = jax.random.PRNGKey(k)
    sp, sm, dp, dm, sf, df = inputs
    picks = _jax_picks(key, _jax_corr_valid(sf, sm, df, dm, True), k)
    args = _t(*inputs)
    chunked = tf.ransac_registration(*args, 0.075, num_hypotheses=k,
                                     picks=picks)
    monkeypatch.setattr(tf, "HYPOTHESIS_CHUNK", 1 << 20)
    flat = tf.ransac_registration(*args, 0.075, num_hypotheses=k,
                                  picks=picks)
    for a, b in zip(chunked, flat):
        assert torch.equal(a, b)
    R_j, t_j, fit_j, _ = jf.ransac_registration(*inputs, key, 0.075,
                                                num_hypotheses=k)
    np.testing.assert_allclose(chunked[0].numpy(), np.asarray(R_j),
                               atol=POSE_TOL)
    np.testing.assert_allclose(chunked[1].numpy(), np.asarray(t_j),
                               atol=POSE_TOL)
    assert np.float32(float(chunked[2])) == np.float32(fit_j)


def test_ransac_constraint_yields_yaw_only(rng):
    src = _L_cloud(rng)
    dst = transform_points(src, get_mat_angle([0.2, 0.1, 0.0], -1.0))
    out, _, _ = tf.fpfh_ransac_pair(src, dst.astype(np.float32),
                                    num_hypotheses=512, max_points=384,
                                    device="cpu")
    assert np.allclose(out[2, :2], 0.0, atol=1e-12)
    assert np.allclose(out[:2, 2], 0.0, atol=1e-12)


def test_ransac_recovers_large_yaw_then_p2p():
    """The port alone, as ``tests/test_fpfh.py`` holds the JAX package: the
    137 degree case lands in the basin, and p2p ICP finishes it."""
    src, dst = _pair(0)
    out, fit, rmse = tf.fpfh_ransac_pair(src, dst, voxel_size=0.05,
                                         num_hypotheses=1024, max_points=512,
                                         device="cpu")
    err = np.linalg.norm(transform_points(src, out) - dst, axis=1)
    assert np.median(err) < 0.35, (np.median(err), fit, rmse)
    assert fit > 0.1
    m = np.ones((1, len(src)), bool)
    tf_icp, fit2, _ = icp_p2point_batch(src[None], m, dst[None], m,
                                        out[None], radius=0.1, its=30,
                                        device="cpu")
    refined = transform_points(src, tf_icp[0])
    assert np.median(np.linalg.norm(refined - dst, axis=1)) < 0.02
    assert fit2[0] > 0.95
    # the JAX package's ICP from the port's answer lands there too
    tf_j, _, _ = jax_icp(src[None], m, dst[None], m, out[None], radius=0.1,
                         its=30)
    assert np.abs(tf_j[0] - tf_icp[0]).max() < 1e-4


def test_draws_depend_on_the_pair_alone():
    """A pair's hypotheses do not change with the other pairs of its call,
    nor with the hypothesis count (rows are drawn in order)."""
    src = [_pair(s, yaw=y)[0] for s, y in ((0, 2.4), (1, -1.2), (2, 0.7))]
    dst = [_pair(s, yaw=y)[1] for s, y in ((0, 2.4), (1, -1.2), (2, 0.7))]
    n = min(len(c) for c in src + dst)
    src = np.stack([c[:n] for c in src])
    dst = np.stack([c[:n] for c in dst])
    m = np.ones(src.shape[:2], bool)
    for method in ("ransac", "fgr"):
        kw = dict(voxel_size=0.05, method=method, max_points=384,
                  num_hypotheses=256, device="cpu")
        all3, fit3, _ = tf.global_registration_batch(src, m, dst, m, **kw)
        one, fit1, _ = tf.global_registration_batch(
            src[1:2], m[1:2], dst[1:2], m[1:2], pair_ids=[1], **kw)
        np.testing.assert_array_equal(all3[1], one[0])
        assert fit3[1] == fit1[0]
    u = tf.pair_uniforms(0, [5], (300, 4), "cpu")
    v = tf.pair_uniforms(0, [5], (100, 4), "cpu")
    assert torch.equal(u[:, :100], v)


def test_draw_without_replacement_law():
    """Distinct valid indices, each valid entry about equally often."""
    valid = torch.zeros((1, 40), dtype=torch.bool)
    valid[0, ::3] = True                       # 14 valid entries
    u = tf.pair_uniforms(3, [0], (20000, 4), "cpu")
    picks = tf.draw_without_replacement(valid, u)[0].numpy()
    assert np.all(valid[0].numpy()[picks])
    assert all(len(set(row)) == 4 for row in picks[:2000])
    counts = np.bincount(picks.ravel(), minlength=40)[::3]
    expected = picks.size / 14
    assert np.abs(counts - expected).max() < 0.05 * expected
    # the first draw alone is uniform too
    first = np.bincount(picks[:, 0], minlength=40)[::3]
    assert np.abs(first - 20000 / 14).max() < 0.1 * 20000 / 14
