"""The port's DGCNN graph ops and exact kNN against the JAX package:
``ops/knn.py`` function by function, and ``knn_points`` (its plain twin on
the CPU) against ``knn_points_pallas`` in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu.ops import knn as jknn
from alignnet3d_tpu.ops.knn_kernels import knn_points_pallas
from alignnet3d_tpu_torch.ops import knn as tknn
from alignnet3d_tpu_torch.ops.knn_kernels import knn_points

torch.set_num_threads(1)


def _points(seed, b, n, distinct=None):
    """(b, n, 3) float32; with ``distinct``, each cloud is that many points
    drawn with replacement, so most distances tie exactly."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        return rng.normal(size=(b, n, 3)).astype(np.float32)
    base = rng.normal(size=(b, distinct, 3))
    pick = rng.integers(0, distinct, (b, n))
    return np.take_along_axis(base, pick[..., None], axis=1).astype(np.float32)


def test_pairwise_distance_matches_jax():
    pts = _points(0, 2, 64)
    ref = np.asarray(jknn.pairwise_distance(jnp.asarray(pts)))
    got = tknn.pairwise_distance(torch.from_numpy(pts)).numpy()
    # the inner products are summed in another order: a few ulps of ~10
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("distinct", [None, 5])
def test_knn_matches_jax_top_k_with_ties(distinct):
    # one distance matrix for both, so only the selection is compared
    neg = np.array(jknn.pairwise_distance(
        jnp.asarray(_points(1, 2, 64, distinct))))
    ref = np.asarray(jknn.knn(jnp.asarray(neg), 20))
    got = tknn.knn(torch.from_numpy(neg), 20)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_knn_approximate_is_not_ported():
    with pytest.raises(NotImplementedError, match="TPU"):
        tknn.knn(torch.zeros((1, 4, 4)), 2, approximate=True)


def test_gather_rows_and_edge_feature_match_jax():
    pts = _points(2, 3, 40)
    idx = np.asarray(jknn.knn(jknn.pairwise_distance(jnp.asarray(pts)), 7))
    t_pts, t_idx = torch.from_numpy(pts), torch.from_numpy(idx.astype(np.int64))
    # pure data movement and one f32 subtraction: bit-equal
    np.testing.assert_array_equal(
        tknn.gather_rows(t_pts, t_idx).numpy(),
        np.asarray(jknn.gather_rows(jnp.asarray(pts), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tknn.get_edge_feature(t_pts, t_idx).numpy(),
        np.asarray(jknn.get_edge_feature(jnp.asarray(pts), jnp.asarray(idx))))


@pytest.mark.parametrize("b,n,k", [(2, 128, 20), (3, 200, 8), (1, 256, 1)])
def test_knn_points_matches_pallas(b, n, k):
    pts = _points(7 + n, b, n)
    ref = np.asarray(knn_points_pallas(jnp.asarray(pts), k, interpret=True))
    got = knn_points(torch.from_numpy(pts), k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, n, k)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_knn_points_matches_pallas_on_a_non_finite_point(value):
    """One coordinate of point 17 of cloud 1 is NaN or infinite. The Pallas
    kernel's argmin rounds rank every NaN distance first, in index order:
    with a NaN point, 17 heads every row of its cloud and row 17 is
    [0, 1, 2, ...]. The twin's order key gives the same rows."""
    pts = _points(17, 2, 40)
    pts[1, 17, 0] = value
    ref = np.asarray(knn_points_pallas(jnp.asarray(pts), 6, interpret=True))
    got = knn_points(torch.from_numpy(pts), 6).numpy()
    np.testing.assert_array_equal(got, ref)
    if np.isnan(value):
        assert (np.delete(got[1, :, 0], 17) == 17).all()
        np.testing.assert_array_equal(got[1, 17], np.arange(6))


def test_knn_points_ranks_nan_before_an_overflowing_distance():
    """|a_i| = |q_i| = 1.5e19: the squares are finite (2.25e38) but the
    cross term overflows, so d2 = -inf for that pair while a NaN point's
    distances are NaN. NaN ranks first, then -inf, as the Pallas kernel
    ranks them."""
    pts = _points(18, 1, 40)
    pts[0, 3] = (1.5e19, 0.0, 0.0)
    pts[0, 9] = (1.5e19, 0.0, 0.0)
    pts[0, 30, 1] = np.nan
    ref = np.asarray(knn_points_pallas(jnp.asarray(pts), 5, interpret=True))
    got = knn_points(torch.from_numpy(pts), 5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 3, 0] == 30 and got[0, 3, 1] == 3 and got[0, 3, 2] == 9


@pytest.mark.parametrize("case", ["pairs", "resampled"])
def test_knn_points_ties_go_to_the_lower_index(case):
    if case == "pairs":  # every point twice, as tests/test_knn_kernels.py
        pts = np.zeros((1, 132, 3), np.float32)
        pts[0, :, 0] = np.repeat(np.arange(66, dtype=np.float32), 2)
        k = 6
    else:  # 5 distinct points resampled to 128, as the serving resampler
        pts, k = _points(3, 2, 128, distinct=5), 20
    ref = np.asarray(knn_points_pallas(jnp.asarray(pts), k, interpret=True))
    got = knn_points(torch.from_numpy(pts), k).numpy()
    np.testing.assert_array_equal(got, ref)
    # within each run of equal distances the indices ascend
    d2 = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
    dsel = np.take_along_axis(d2, got, axis=2)
    tie = dsel[..., 1:] == dsel[..., :-1]
    assert tie.any()
    assert (got[..., 1:] > got[..., :-1])[tie].all()


def test_knn_points_agrees_with_the_xla_graph():
    pts = torch.from_numpy(_points(4, 2, 96))
    np.testing.assert_array_equal(
        knn_points(pts, 20).numpy(),
        tknn.knn(tknn.pairwise_distance(pts), 20).numpy())
