"""The training edge stage's pick of the max over k (``select_plain``, the
plain version of the kernel's fwd and select passes) against the twin
``fused_edge_stage_train_plain``, and the batch slices of the per-cloud
kernels (``ops/_batch.py``). No jax: these run on any machine."""

import numpy as np
import pytest
import torch

from alignnet3d_tpu_torch.ops import _batch
from alignnet3d_tpu_torch.ops import edge_train_kernels as et
from alignnet3d_tpu_torch.ops import knn_kernels as kk
from alignnet3d_tpu_torch.ops.edge_conv_kernels import _split

torch.set_num_threads(1)


def _inputs(seed, b=3, n=64, k=10, c1=16, c2=24, distinct=None):
    """f, idx and the eight parameters of the stage, seeded; with
    ``distinct``, each cloud is that many points drawn with replacement
    (bit-identical duplicates: exact ties over k)."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        pts = rng.normal(size=(b, n, 3)) * 3.0
    else:
        base = rng.normal(size=(b, distinct, 3)) * 3.0
        pts = np.take_along_axis(
            base, rng.integers(0, distinct, (b, n))[..., None], axis=1)
    f = torch.from_numpy(pts.astype(np.float32))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    params = [t(rng.normal(size=(6, c1)) * 0.4),
              t(rng.normal(size=(c1,)) * 0.1),
              t(1.0 + 0.2 * rng.normal(size=(c1,))),
              t(0.1 * rng.normal(size=(c1,))),
              t(rng.normal(size=(c1, c2)) / np.sqrt(c1)),
              t(rng.normal(size=(c2,)) * 0.1),
              t(1.0 + 0.2 * rng.normal(size=(c2,))),
              t(0.1 * rng.normal(size=(c2,)))]
    return f, kk.knn_points_plain(f, k), params


def _twin_pre2(f, idx, params):
    """pre2 of every edge and BN2's statistics, by the twin's operations."""
    w1, b1, g1, be1, w2, b2, _, _ = params
    u, v = _split(f, w1, b1)
    bsz, n, c1 = u.shape
    rows = (idx + (torch.arange(bsz) * n)[:, None, None]).reshape(-1)
    vj = v.reshape(bsz * n, c1).index_select(0, rows).reshape(*idx.shape, c1)
    y1 = et._batch_norm_train(u[:, :, None, :] + vj, g1, be1, et.EPS)[0]
    pre2 = torch.matmul(torch.relu(y1), w2) + b2
    mu2 = torch.mean(pre2, dim=(0, 1, 2))
    var2 = torch.mean(torch.square(pre2), dim=(0, 1, 2)) - torch.square(mu2)
    return pre2, mu2, var2


@pytest.mark.parametrize("case", ["random", "negative_and_zero_g2", "tied",
                                  "nan"])
def test_select_plain_matches_the_twins_max(case):
    """out equals the twin's bit for bit; the slot is the twin's first
    argmax of h2 wherever out > 0, unless two t's give equal h2 (a rounding
    collapse, where the cotangent's slot does not change out); xhat2 is
    the twin's at the slot. ``nan``: a NaN coordinate in f makes every
    statistic NaN, so out and xhat2 are NaN everywhere, as the twin's."""
    f, idx, params = _inputs(30, distinct=5 if case == "tied" else None)
    if case == "negative_and_zero_g2":
        params[6][::3] = -params[6][::3]
        params[6][5] = 0.0
    if case == "nan":
        f[1, 7, 2] = float("nan")
    g2, be2 = params[6], params[7]
    pre2, mu2, var2 = _twin_pre2(f, idx, params)
    xhat = (pre2 - mu2) * torch.rsqrt(var2 + et.EPS)
    h2 = torch.relu(xhat * g2 + be2)
    r_out = et.fused_edge_stage_train_plain(f, idx, *params)[0]
    r_slot = torch.argmax(h2, dim=2)
    out, slot, xhat2 = et.select_plain(pre2, g2, be2, mu2, var2)
    nan = torch.isnan(r_out)
    assert torch.equal(torch.isnan(h2.amax(2)), nan)
    assert torch.equal(h2.amax(2)[~nan], r_out[~nan])
    assert torch.equal(torch.isnan(out), nan)
    assert bool(nan.all()) if case == "nan" else not bool(nan.any())
    assert torch.equal(torch.isnan(xhat2), nan)
    assert torch.equal(out[~nan], r_out[~nan])
    live = r_out > 0
    at = torch.gather(h2, 2, slot[:, :, None]).squeeze(2)
    r_at = torch.gather(h2, 2, r_slot[:, :, None]).squeeze(2)
    collapse = (slot != r_slot) & (at == r_at)
    assert bool(((slot == r_slot) | collapse)[live].all())
    assert int(collapse[live].sum()) < 0.01 * max(int(live.sum()), 1)
    r_xhat2 = torch.gather(xhat, 2, slot[:, :, None]).squeeze(2)
    assert torch.equal(xhat2[~nan], r_xhat2[~nan])
    if case == "negative_and_zero_g2":
        assert bool((slot[..., 5] == 0).all())
        assert bool((slot[..., 0] == torch.argmin(pre2[..., 0], 2)).all())


@pytest.mark.parametrize("batch", [1, 65535, 65536, 131071])
def test_batch_chunks_cover_the_batch_in_order(batch):
    chunks = _batch.batch_chunks(batch)
    assert chunks[0][0] == 0 and chunks[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < stop - start <= _batch.MAX_CLOUDS for start, stop in chunks)
    assert len(chunks) == -(-batch // _batch.MAX_CLOUDS)
