"""fused_pointnet: the plain PyTorch twin against the JAX package's XLA
reference and its Pallas kernel (interpret mode on the CPU). The CUDA
kernel is held to the twin in tests/test_torch_gpu_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from alignnet3d_tpu.ops.pointnet_kernels import (
    fused_pointnet_pallas,
    fused_pointnet_xla,
)
from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

DIMS = [3, 16, 32, 64]
CASES = [
    # (compute dtype pair, rtol/atol, why)
    (jnp.float32, torch.float32, 1e-5),  # f32: summation order only
    # bf16: the same roundings happen at the same places, but a summation-
    # order difference can flip one activation's bf16 rounding (1 ulp,
    # 2^-8 relative), which the next layers carry
    (jnp.bfloat16, torch.bfloat16, 2e-2),
]


def _inputs(seed=3, b=8, n=128, dims=DIMS):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(b, n, dims[0])).astype(np.float32)
    weights = [(rng.normal(size=(dims[i], dims[i + 1])) * 0.3).astype(np.float32)
               for i in range(len(dims) - 1)]
    biases = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32)
              for i in range(len(dims) - 1)]
    return points, weights, biases


def _plain(points, weights, biases, dtype):
    return pk.fused_pointnet_plain(
        torch.from_numpy(points), [torch.from_numpy(w) for w in weights],
        [torch.from_numpy(b) for b in biases], dtype).numpy()


@pytest.mark.parametrize("jdt,tdt,tol", CASES)
def test_plain_matches_xla(jdt, tdt, tol):
    points, weights, biases = _inputs()
    ref = fused_pointnet_xla(jnp.asarray(points),
                             [jnp.asarray(w) for w in weights],
                             [jnp.asarray(b) for b in biases], compute_dtype=jdt)
    np.testing.assert_allclose(_plain(points, weights, biases, tdt),
                               np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("jdt,tdt,tol", CASES)
def test_plain_matches_pallas_interpret(jdt, tdt, tol):
    points, weights, biases = _inputs(seed=4)
    ref = fused_pointnet_pallas(
        jnp.asarray(points), tuple(jnp.asarray(w) for w in weights),
        tuple(jnp.asarray(b) for b in biases), tb=4, tn=32,
        compute_dtype=jdt, interpret=True)
    np.testing.assert_allclose(_plain(points, weights, biases, tdt),
                               np.asarray(ref), rtol=tol, atol=tol)


def test_bf16_rounds_like_jax():
    """With one layer there is no summation to reorder: bf16 inputs times
    bf16 weights accumulate exactly in f32 (3 terms of 8-bit mantissas),
    so the twin's bf16 result equals the XLA reference bit for bit."""
    points, weights, biases = _inputs(seed=5, dims=[3, 64])
    ref = fused_pointnet_xla(jnp.asarray(points), [jnp.asarray(weights[0])],
                             [jnp.asarray(biases[0])],
                             compute_dtype=jnp.bfloat16)
    got = _plain(points, weights, biases, torch.bfloat16)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # and the rounding is really there: f32 differs
    assert not np.array_equal(got, _plain(points, weights, biases,
                                          torch.float32))


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_non_finite_point_matches_xla(value):
    """One non-finite coordinate: the twin is NaN where the XLA reference
    is (torch.relu and amax propagate NaN as jnp.maximum and jnp.max do)
    and agrees elsewhere, infinities included. The CUDA kernel is held to
    the twin on such inputs in tests/test_torch_gpu_kernels.py."""
    points, weights, biases = _inputs(seed=6)
    points[2, 5, 1] = value
    ref = np.asarray(fused_pointnet_xla(jnp.asarray(points),
                                        [jnp.asarray(w) for w in weights],
                                        [jnp.asarray(b) for b in biases],
                                        compute_dtype=jnp.float32))
    got = _plain(points, weights, biases, torch.float32)
    nan = np.isnan(ref)
    assert nan[2].any() and not nan[np.arange(8) != 2].any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_the_twin_without_launching():
    points, weights, biases = _inputs()
    before = pk.fused_pointnet.launches
    got = pk.fused_pointnet(torch.from_numpy(points),
                            [torch.from_numpy(w) for w in weights],
                            [torch.from_numpy(b) for b in biases])
    assert pk.fused_pointnet.launches == before
    np.testing.assert_array_equal(
        got.numpy(), _plain(points, weights, biases, torch.float32))
