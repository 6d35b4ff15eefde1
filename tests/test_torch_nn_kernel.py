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


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_non_finite_points_match_xla(value):
    """A non-finite coordinate in a source point, in a valid and in a masked
    destination point: the twin returns the XLA path's index everywhere
    (``jnp.argmin`` and ``torch.argmin`` both take the first NaN, a masked
    column's included) and its d2, NaN in the same places. The XLA path is
    the reference: the Pallas kernel's strict-less tile minimum never
    takes a NaN distance."""
    src, dst, mask = _inputs(7, 3, 40, 64, (64, 50, 40))
    src[0, 3, 1] = value
    dst[1, 20, 2] = value  # valid
    dst[1, 55, 0] = value  # masked
    dst[2, 50, 0] = value  # masked, the pair's only fault
    gi, gd = _plain(src, dst, mask)
    ri, rd = jax.vmap(_nn_correspondences)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    ri, rd = np.asarray(ri), np.asarray(rd)
    np.testing.assert_array_equal(gi, ri)
    nan = np.isnan(rd)
    assert nan[1].any()
    np.testing.assert_array_equal(np.isnan(gd), nan)
    np.testing.assert_allclose(gd[~nan], rd[~nan], rtol=D2_TOL, atol=D2_TOL)


def test_cpu_tensor_takes_the_twin_without_launching():
    src, dst, mask = _inputs(2, 2, 20, 30, (30, 30))
    before = nk.nn_argmin.launches
    idx, _ = nk.nn_argmin(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(mask))
    assert nk.nn_argmin.launches == before
    np.testing.assert_array_equal(idx.numpy(), _plain(src, dst, mask)[0])


def _np_table(dst, mask):
    """The kernel's column table in numpy: rows (-2x, -2y, -2z, |q|^2 or
    +inf), float32 with every product and sum rounded on its own, padded
    with (0, 0, 0, +inf) to a multiple of nk.GROUP."""
    b, n2, _ = dst.shape
    n2p = -(-n2 // nk.GROUP) * nk.GROUP
    table = np.zeros((b, n2p, 4), np.float32)
    table[..., 3] = np.inf
    sq = (dst[..., 0] * dst[..., 0] + dst[..., 1] * dst[..., 1]
          + dst[..., 2] * dst[..., 2])
    table[:, :n2, :3] = np.float32(-2.0) * dst
    table[:, :n2, 3] = np.where(mask, sq, np.float32(np.inf))
    return table


@pytest.mark.parametrize("n2,counts", [
    (40, (40, 0, 1, 17)),    # a multiple of the group; a fully masked pair
    (37, (37, 5, 0, 36)),    # padded to 40
])
def test_column_table_matches_numpy(n2, counts):
    rng = np.random.default_rng(n2)
    dst = (rng.normal(size=(len(counts), n2, 3)) * 10).astype(np.float32)
    mask = np.arange(n2)[None, :] < np.array(counts)[:, None]
    table, cols = nk.column_table(torch.from_numpy(dst), torch.from_numpy(mask))
    assert table.dtype == torch.float32 and cols.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), _np_table(dst, mask))
    np.testing.assert_array_equal(cols.numpy(), counts)


def test_column_count_is_one_past_the_last_valid_column():
    mask = np.zeros((4, 21), bool)
    mask[0, [0, 3, 9]] = True     # holes: sweep to the last valid column
    mask[1, 20] = True
    mask[2, 0] = True
    dst = np.ones((4, 21, 3), np.float32)
    table, cols = nk.column_table(torch.from_numpy(dst), torch.from_numpy(mask))
    np.testing.assert_array_equal(cols.numpy(), [10, 21, 1, 0])
    np.testing.assert_array_equal(table.numpy(), _np_table(dst, mask))


def test_column_table_is_the_plain_versions_arithmetic():
    """The table's |q|^2 column is nn_argmin_plain's masked |q|^2 bit for
    bit (same tensor ops), so the kernel's sums start from the same values."""
    src, dst, mask = _inputs(6, 3, 20, 64, (64, 10, 0))
    table, _ = nk.column_table(torch.from_numpy(dst), torch.from_numpy(mask))
    sq = nk._sq_norm(torch.from_numpy(dst))
    want = torch.where(torch.from_numpy(mask), sq, float("inf"))
    assert torch.equal(table[..., 3], want)
    assert torch.equal(table[..., :3], -2.0 * torch.from_numpy(dst))
