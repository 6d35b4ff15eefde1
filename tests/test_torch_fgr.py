"""The port's Fast Global Registration against the JAX package on the CPU:
``alignnet3d_tpu.icp.fgr`` and ``alignnet3d_tpu_torch.icp.fgr`` on the same
numpy-seeded L-cloud pairs and descriptors.

Tolerances:
- reciprocal matches: the port's are the exact (float64) ones; the JAX
  package's agree where both directions are decided beyond its float32
  rounding (``tests/test_torch_fpfh.py``, MATCH_MARGIN);
- the tuple test with the JAX package's own triplets injected
  (``jax.random.choice(replace=True)`` on the same key): the same kept set;
- FGR with those triplets: 64 graduated non-convexity iterations of the
  closed-form update, float32 in the JAX package and float64 in the port,
  so R and t within 1e-4, the inlier count equal, the rmse within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu.geometry import get_mat_angle, transform_points
from alignnet3d_tpu.icp import fgr as jg
from alignnet3d_tpu.icp import fpfh as jf
from alignnet3d_tpu_torch.icp import fgr as tg
from alignnet3d_tpu_torch.icp import fpfh as tf
from alignnet3d_tpu_torch.icp.p2point import icp_p2point_batch
from tests.test_fpfh import _L_cloud
from tests.test_torch_fpfh import (
    _exact_matches,
    _features,
    _pair,
    _ransac_inputs,
    _t,
)

torch.set_num_threads(1)

FGR_TOL = 1e-4


@pytest.mark.parametrize("kind", ["random", "fpfh"])
def test_mutual_correspondences_match_jax(kind):
    fs, ms, fd, md = _features(9, kind)
    fwd_j, valid_j = (np.asarray(x) for x in jg._mutual_correspondences(
        *(jnp.asarray(x) for x in (fs, ms, fd, md))))
    fwd, valid = (x[0].numpy() for x in tg._mutual_correspondences(
        *_t(fs[None], ms[None], fd[None], md[None])))
    # exact, in float64: src -> dst over valid dst, dst -> src over valid src
    exact_f, dec_f = _exact_matches(fs, fd, md)
    exact_b, dec_b = _exact_matches(fd, fs, ms)
    exact_valid = ms & md[exact_f] & (exact_b[exact_f] == np.arange(len(fs)))
    np.testing.assert_array_equal(fwd[ms], exact_f[ms])
    np.testing.assert_array_equal(valid, exact_valid)
    held = ms & dec_f & dec_b[exact_f]
    assert held.sum() >= 0.5 * ms.sum()
    np.testing.assert_array_equal(fwd[held], fwd_j[held])
    np.testing.assert_array_equal(valid[held], valid_j[held])


def _jax_triplets(key, valid, num_tuples):
    """The draws of ``jg._tuple_test``."""
    prob = valid.astype(jnp.float32)
    prob = prob / jnp.maximum(jnp.sum(prob), 1.0)
    return np.array(jax.jit(lambda k, p: jax.random.choice(
        k, valid.shape[0], (num_tuples, 3), replace=True, p=p))(key, prob))


@pytest.mark.parametrize("tau", [0.9, 0.97])
def test_tuple_test_with_jax_draws_matches_jax(tau):
    sp, sm, dp, dm, sf, df = _ransac_inputs(10)
    corr, valid = jg._mutual_correspondences(sf, sm, df, dm)
    q = dp[corr]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jg._tuple_test(sp, q, valid, key, 1000, tau))
    picks = _jax_triplets(key, valid, 1000)
    got = tg._tuple_test(*_t(sp[None], q[None], valid[None]), 1000, tau,
                         picks=picks[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()   # it kept some, dropped some


def _fgr_both(inputs, keys, **kw):
    """The JAX package's FGR, and the port's with its triplets injected."""
    sp, sm, dp, dm, sf, df = inputs
    want = jg.fgr_batch_jit(sp, sm, dp, dm, sf, df, keys, **kw)
    picks = []
    for b in range(sp.shape[0]):
        _, valid = jg._mutual_correspondences(sf[b], sm[b], df[b], dm[b])
        picks.append(_jax_triplets(keys[b], valid, kw.get("num_tuples",
                                                           1000)))
    got = tg.fgr_batch(*_t(*inputs), picks=np.stack(picks), **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("constrained", [True, False])
def test_fgr_with_jax_draws_matches_jax(constrained):
    pairs = [_ransac_inputs(s, yaw=y) for s, y in ((11, 2.4), (12, -0.9))]
    inputs = tuple(jnp.stack([p[i] for p in pairs]) for i in range(6))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    (R_j, t_j, fit_j, rmse_j), (R, t, fit, rmse) = _fgr_both(
        inputs, keys, with_constraint=constrained, distance_threshold=0.075)
    np.testing.assert_allclose(R, R_j, atol=FGR_TOL)
    np.testing.assert_allclose(t, t_j, atol=FGR_TOL)
    np.testing.assert_array_equal(fit.astype(np.float32), fit_j)
    np.testing.assert_allclose(rmse, rmse_j, atol=1e-5)
    assert np.all(fit > 0.9)     # both motions found
    if constrained:
        np.testing.assert_allclose(R[:, 2], [[0, 0, 1]] * 2, atol=1e-12)


def test_fgr_falls_back_to_the_mutual_set_like_jax():
    """tau = 1 lets no triplet pass: both packages optimise over all the
    reciprocal matches."""
    inputs = tuple(x[None] for x in _ransac_inputs(13))
    keys = jax.random.split(jax.random.PRNGKey(1), 1)
    (R_j, t_j, fit_j, _), (R, t, fit, _) = _fgr_both(inputs, keys, tau=1.0)
    np.testing.assert_allclose(R, R_j, atol=FGR_TOL)
    np.testing.assert_allclose(t, t_j, atol=FGR_TOL)
    np.testing.assert_array_equal(fit.astype(np.float32), fit_j)
    # and the port's own draws take the same path
    R2, t2, _, _ = tg.fgr_batch(*_t(*inputs), tau=1.0)
    np.testing.assert_array_equal(R2.numpy(), R)


def test_fgr_recovers_large_yaw_then_p2p():
    """The port alone, as ``tests/test_fpfh.py`` holds the JAX package."""
    src, dst = _pair(0)
    m = np.ones((1, len(src)), bool)
    out, fit, rmse = tf.global_registration_batch(
        src[None], m, dst[None], m, voxel_size=0.05, method="fgr",
        max_points=512, device="cpu")
    err = np.linalg.norm(transform_points(src, out[0]) - dst, axis=1)
    assert np.median(err) < 0.35, (np.median(err), fit, rmse)
    tf_icp, _, _ = icp_p2point_batch(src[None], m, dst[None], m, out,
                                     radius=0.1, its=30, device="cpu")
    refined = transform_points(src, tf_icp[0])
    assert np.median(np.linalg.norm(refined - dst, axis=1)) < 0.02


def test_fgr_constraint_yields_yaw_only(rng):
    src = _L_cloud(rng)
    dst = transform_points(src, get_mat_angle([0.2, 0.1, 0.0], -1.0))
    m = np.ones((1, len(src)), bool)
    out, _, _ = tf.global_registration_batch(
        src[None], m, dst[None].astype(np.float32), m, voxel_size=0.05,
        method="fgr", max_points=384, device="cpu")
    assert np.allclose(out[0][2, :2], 0.0, atol=1e-12)
    assert np.allclose(out[0][:2, 2], 0.0, atol=1e-12)


def test_draw_with_replacement_law():
    valid = torch.zeros((2, 30), dtype=torch.bool)
    valid[0, 5:15] = True
    valid[1, ::2] = True
    u = tf.pair_uniforms(4, [0, 1], (30000, 3), "cpu")
    picks = tg.draw_with_replacement(valid, u).numpy()
    for b in range(2):
        ok = valid[b].numpy()
        assert np.all(ok[picks[b]])
        counts = np.bincount(picks[b].ravel(), minlength=30)[ok]
        expected = picks[b].size / ok.sum()
        assert np.abs(counts - expected).max() < 0.05 * expected
    # no valid entry: every draw is the last index, never out of range
    none = tg.draw_with_replacement(torch.zeros((1, 7), dtype=torch.bool),
                                    u[:1, :5])
    assert int(none.max()) == 6
