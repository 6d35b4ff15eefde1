"""nn_argmin: the plain PyTorch twin against the JAX package's Pallas
kernel (interpret mode on the CPU) and its XLA path
(``p2point._nn_correspondences``), with masks. The CUDA kernel is held to
the twin in tests/test_torch_gpu_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from alignnet3d_tpu.icp.p2point import _nn_correspondences
from alignnet3d_tpu.ops.nn_kernels import nn_argmin_pallas
from alignnet3d_tpu_torch.ops import nn_kernels as nk

# the three computations order the f32 expansion differently: d2 agrees to
# a few ulps of |a|^2 + |b|^2 (~10 for unit normals)
D2_TOL = 1e-5


def _away_from_ties(src, dst, mask, margin=1e-3):
    """Drop source points whose two nearest valid distances (f64) lie
    within ``margin``: there the argmin is decided by rounding."""
    d = ((src[:, :, None, :].astype(np.float64)
          - dst[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    d[~np.broadcast_to(mask[:, None, :], d.shape)] = np.inf
    two = np.sort(d, axis=-1)[..., :2]
    return np.all(two[..., 1] - two[..., 0] > margin, axis=0)


def _inputs(seed, b, n1, n2, n_valid):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n1, 3)).astype(np.float32)
    dst = rng.normal(size=(b, n2, 3)).astype(np.float32)
    mask = np.zeros((b, n2), bool)
    for i, nv in enumerate(n_valid):
        mask[i, :nv] = True
    keep = _away_from_ties(src, dst, mask)
    return np.ascontiguousarray(src[:, keep]), dst, mask


def _plain(src, dst, mask):
    idx, d2 = nk.nn_argmin_plain(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask))
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("b,n1,n2,n_valid", [
    (3, 16, 40, (33, 40, 1)),
    (2, 130, 700, (650, 700)),
    (2, 300, 1300, (1300, 900)),
])
def test_plain_matches_pallas_and_xla(b, n1, n2, n_valid):
    src, dst, mask = _inputs(b + n1, b, n1, n2, n_valid)
    gi, gd = _plain(src, dst, mask)
    args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    for name, fn in (("pallas", nn_argmin_pallas),
                     ("xla", _nn_correspondences)):
        ri, rd = jax.vmap(fn)(*args)
        np.testing.assert_array_equal(gi, np.asarray(ri), err_msg=name)
        np.testing.assert_allclose(gd, np.asarray(rd), rtol=D2_TOL,
                                   atol=D2_TOL, err_msg=name)


def test_plain_chunks_agree_with_one_block(monkeypatch):
    src, dst, mask = _inputs(1, 2, 50, 64, (64, 30))
    whole = _plain(src, dst, mask)
    monkeypatch.setitem(nk._CHUNK_ELEMS, "cpu", 2 * 64 * 7)  # 7-row chunks
    chunked = _plain(src, dst, mask)
    for w, c in zip(whole, chunked):
        np.testing.assert_array_equal(w, c)


def test_ties_and_fully_masked_rows():
    src = np.zeros((2, 2, 3), np.float32)
    dst = np.zeros((2, 4, 3), np.float32)
    dst[:, :, 0] = [1.0, -1.0, 1.0, 2.0]  # columns 0, 1, 2 tie at d2 = 1
    mask = np.array([[False, True, True, True], [False] * 4])
    idx, d2 = _plain(src, dst, mask)
    np.testing.assert_array_equal(idx[0], [1, 1])  # lowest VALID index
    np.testing.assert_array_equal(d2[0], [1.0, 1.0])
    # no valid column: index 0, +inf, as the XLA path gives
    ri, rd = jax.vmap(_nn_correspondences)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    np.testing.assert_array_equal(idx[1], np.asarray(ri)[1])
    assert np.all(np.isinf(d2[1])) and np.all(np.isinf(np.asarray(rd)[1]))


def test_cpu_tensor_takes_the_twin_without_launching():
    src, dst, mask = _inputs(2, 2, 20, 30, (30, 30))
    before = nk.nn_argmin.launches
    idx, _ = nk.nn_argmin(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(mask))
    assert nk.nn_argmin.launches == before
    np.testing.assert_array_equal(idx.numpy(), _plain(src, dst, mask)[0])
