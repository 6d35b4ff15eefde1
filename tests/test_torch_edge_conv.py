"""The port's fused edge-conv stage (its plain twin on the CPU) against the
JAX package's ``fused_edge_stage`` in interpret mode, at the shapes of
tests/test_edge_conv_kernels.py, and against the unfused edge graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu.ops.edge_conv_kernels import fused_edge_stage as jax_stage
from alignnet3d_tpu.ops.knn import get_edge_feature as get_edge_feature_jax
from alignnet3d_tpu.ops.knn import knn, pairwise_distance
from alignnet3d_tpu.ops.knn_kernels import knn_points_pallas
from alignnet3d_tpu_torch.ops.edge_conv_kernels import (
    fused_edge_stage, fused_edge_stage_plain)
from alignnet3d_tpu_torch.ops.knn import get_edge_feature

torch.set_num_threads(1)

# f32 throughout; the two differ only in the summation order of the C1=64
# products, as tests/test_edge_conv_kernels.py allows the JAX kernel
TOL = 2e-5


def _inputs(seed, b, n, k, c, c2, zero_bias=False):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = np.asarray(knn(pairwise_distance(jnp.asarray(pts)), k))
    w1 = (rng.normal(size=(2 * c, 64)) / 2.0).astype(np.float32)
    b1 = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(64, c2)) / 8.0).astype(np.float32)
    b2 = (rng.normal(size=(c2,)) * 0.1).astype(np.float32)
    if zero_bias:
        b1, b2 = np.zeros_like(b1), np.zeros_like(b2)
    return pts, idx, w1, b1, w2, b2


@pytest.mark.parametrize("b,n,k,c2,zero_bias", [
    (2, 128, 8, 128, False),
    (1, 200, 20, 128, False),
    (3, 256, 5, 128, False),
    (2, 160, 10, 256, True),   # the wide-feature case of the JAX tests
])
def test_fused_edge_stage_matches_jax(b, n, k, c2, zero_bias):
    pts, idx, w1, b1, w2, b2 = _inputs(0, b, n, k, 3, c2, zero_bias)
    ref = np.asarray(jax_stage(*(jnp.asarray(a) for a in
                                 (pts, idx, w1, b1, w2, b2)),
                               interpret=True))
    got = fused_edge_stage(torch.from_numpy(pts),
                           torch.from_numpy(idx.astype(np.int64)),
                           *(torch.from_numpy(a) for a in (w1, b1, w2, b2)))
    assert tuple(got.shape) == (b, n, c2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("graph", ["finite", "with_the_point"])
def test_fused_edge_stage_plain_matches_the_jax_gather_on_a_nan_point(graph):
    """A NaN coordinate in point 17 of cloud 1, against the JAX gather
    composition its kernel's docstring names (get_edge_feature, two
    relu-dense layers, max over k): NaN in the same places, the rest within
    TOL. Over the finite points' graph only the rows that touch the point
    are NaN; over the graph of the cloud as it is (knn_points_pallas ranks
    a NaN distance first) every row of the cloud is. The Pallas kernel
    itself spreads the NaN to the whole cloud in both cases (its one-hot
    gather multiplies 0 x NaN), so it is not the reference here."""
    pts, idx, w1, b1, w2, b2 = _inputs(4, 2, 96, 20, 3, 128)
    pts[1, 17, 0] = np.nan
    if graph == "with_the_point":
        idx = np.asarray(knn_points_pallas(jnp.asarray(pts), 20,
                                           interpret=True))
    e = get_edge_feature_jax(jnp.asarray(pts), jnp.asarray(idx))
    h = jnp.maximum(e @ jnp.asarray(w1) + jnp.asarray(b1), 0.0)
    h = jnp.maximum(h @ jnp.asarray(w2) + jnp.asarray(b2), 0.0)
    ref = np.asarray(jnp.max(h, axis=2))
    got = fused_edge_stage_plain(
        torch.from_numpy(pts), torch.from_numpy(idx.astype(np.int64)),
        *(torch.from_numpy(a) for a in (w1, b1, w2, b2))).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert not nan[0].any()
    assert nan[1].all() if graph == "with_the_point" else (
        0 < nan[1].any(-1).sum() < 96)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=TOL, atol=TOL)


def test_fused_edge_stage_matches_the_edge_graph():
    """The linear split against relu(edge @ w1 + b1) on the materialised
    [x_i, x_j - x_i] tensor, as the JAX kernel's docstring states it."""
    pts, idx, w1, b1, w2, b2 = (torch.from_numpy(np.array(a)) for a in
                                _inputs(1, 2, 96, 20, 3, 128))
    idx = idx.to(torch.int64)
    edge = get_edge_feature(pts, idx)
    h = torch.relu(torch.relu(edge @ w1 + b1) @ w2 + b2)
    torch.testing.assert_close(fused_edge_stage(pts, idx, w1, b1, w2, b2),
                               torch.amax(h, dim=2), rtol=TOL, atol=TOL)
