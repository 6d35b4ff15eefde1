"""FPFH features + RANSAC global registration.

Counterpart of ``alignnet3d_tpu/icp/fpfh.py``, the reference's Open3D
global-registration pipeline (reference icp.py:85-119,
tp_utils/pointcloud.py:1192-1206): voxel downsample -> normals -> FPFH
descriptors -> feature correspondences -> RANSAC over constrained rigid
transforms. The voxel downsample is host numpy, copied from the JAX
package; everything after it runs on padded (B, N, ...) tensors with an
explicit batch axis:

- normals: the eigenvector of the smallest eigenvalue of the k=16
  neighbourhood covariance (in closed form: one set of elementwise ops,
  which the card and the CPU round alike), flipped toward the sensor at
  the origin;
- SPFH/FPFH: the Darboux-frame triplet (alpha, phi, theta) histogrammed
  into 3 x 11 percentage bins over the radius-gated k=32 neighbourhood,
  plus the distance-weighted neighbour average (Rusu et al. 2009);
- RANSAC: ``num_hypotheses`` minimal samples of ``ransac_n``
  correspondences each, the 0.9 edge-length checker, the closed-form
  (optionally yaw-only) estimate, and the inlier count over the whole
  correspondence set; the first best hypothesis wins.

Precision: the neighbour search runs in float32 with the JAX package's
ordering (``p2plane._knn``); normals, features, feature distances and
hypothesis scores run in float64. Feature distances feed an argmin and
hypothesis scores an argmax: in float64 the card and the CPU round them
alike except on gaps near 1e-16 relative, where float32 products (and
TF32 ones all the more) reorder near-ties.

Random draws: a pair's RANSAC picks come from uniforms made on the host by
a numpy generator seeded with (seed, the pair's position in the val set),
one row per hypothesis, so they do not depend on the device, the chunk of
pairs or the hypothesis count. Each draw takes the ``floor(u m)``-th of the
m correspondences not yet picked: sampling without replacement with equal
weights, the law of ``jax.random.choice(replace=False, p=mask / sum)``.
"""

from __future__ import annotations

import numpy as np
import torch

from alignnet3d_tpu_torch.icp.p2plane import _knn
from alignnet3d_tpu_torch.icp.p2point import (
    _estimate_full,
    _estimate_yaw_translation,
    gather_points,
)

N_BINS = 11  # per angle feature, 33-dim FPFH total (Open3D layout)
NORMAL_K = 16  # neighbours of a normal
HYPOTHESIS_CHUNK = 2048  # hypotheses scored at once, as the JAX package
# elements of one float64 (pairs, hypotheses, points) or (pairs, N, N) block
_BLOCK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     max_points: int | None = None):
    """Centroid-per-voxel downsample (o3.voxel_down_sample equivalent),
    vectorized numpy (host-side prep)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    # lexicographic voxel id
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv, pts)
    out = sums / counts[:, None]
    if max_points is not None and len(out) > max_points:
        pick = np.random.default_rng(0).choice(len(out), max_points,
                                               replace=False)
        out = out[pick]
    return out.astype(np.float32)


def prep_downsampled_batch(clouds, masks, voxel_size: float,
                           max_points: int = 2048):
    """Host-side voxel downsample of a chunk of padded clouds into one
    padded (B, max_points, 3) array + mask (the only non-device stage of
    the global-registration pipeline)."""
    b = len(clouds)
    pts = np.zeros((b, max_points, 3), np.float32)
    msk = np.zeros((b, max_points), bool)
    for i in range(b):
        cloud = clouds[i][masks[i]] if masks is not None else clouds[i]
        down = voxel_downsample(cloud, voxel_size, max_points=max_points)
        c = min(len(down), max_points)
        pts[i, :c] = down[:c]
        msk[i, :c] = True
    return pts, msk


def _block(device: torch.device, per_item: int) -> int:
    """Items of ``per_item`` elements that fit one block on ``device``."""
    return max(1, _BLOCK_ELEMS.get(device.type, 1 << 22) // max(1, per_item))


def _gather_rows(x, idx):
    """x (B, N, C), idx (B, N, k) -> (B, N, k, C)."""
    b, n, k = idx.shape
    return gather_points(x, idx.reshape(b, n * k)).reshape(b, n, k, -1)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _smallest_eigenvector(cov):
    """(..., 3, 3) symmetric -> (..., 3) unit eigenvector of the smallest
    eigenvalue, in closed form: the eigenvalue by the trigonometric
    solution of the characteristic cubic, the vector as the longest cross
    product of two rows of cov - l0 I. Where l0 is a double eigenvalue the
    vector is any unit one orthogonal to the remaining direction, as
    ``eigh``'s is arbitrary there; (1, 0, 0) for a multiple of I."""
    a00, a11, a22 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    a01, a02, a12 = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1) / 6.0)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / torch.clamp_min(2.0 * p * p * p, 1e-300), -1.0, 1.0)
    lam0 = q + 2.0 * p * torch.cos(torch.acos(r) / 3.0 + 2.0 * np.pi / 3.0)
    rows = cov - lam0[..., None, None] * torch.eye(
        3, dtype=cov.dtype, device=cov.device)
    r0, r1, r2 = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]
    cands = torch.stack([_cross3(r0, r1), _cross3(r0, r2), _cross3(r1, r2)],
                        dim=-2)
    n2 = _dot3(cands, cands)                               # (..., 3)
    best = torch.gather(cands, -2, n2.argmax(-1)[..., None, None].expand(
        *n2.shape[:-1], 1, 3))[..., 0, :]
    best_n2 = n2.amax(-1)
    # a double smallest eigenvalue: rank(cov - l0 I) <= 1, its longest row
    # spans the other eigenvector; take a unit vector orthogonal to it
    rn = _dot3(rows, rows)
    row = torch.gather(rows, -2, rn.argmax(-1)[..., None, None].expand(
        *rn.shape[:-1], 1, 3))[..., 0, :]
    axis = torch.zeros_like(row)
    axis.scatter_(-1, row.abs().argmin(-1, keepdim=True), 1.0)
    ortho = _cross3(row, axis)
    scale = torch.clamp_min(rn.amax(-1), 1e-300)
    # relative to the squared scale of cov - l0 I
    degenerate = best_n2 <= 1e-20 * scale * scale
    v = torch.where(degenerate[..., None], ortho, best)
    flat = rn.amax(-1) <= 1e-30 * torch.clamp_min(q * q, 1e-300)
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    v = torch.where(flat[..., None], e0, v)
    return v / torch.sqrt(_dot3(v, v))[..., None]


def _normals(points, idx):
    """Unit normals (float64) of float32 clouds (B, N, 3) from their
    neighbour lists (B, N, k), oriented toward the origin (the sensor)."""
    neigh = _gather_rows(points.to(torch.float64), idx)   # (B, N, k, 3)
    centered = neigh - neigh.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnki,bnkj->bnij", centered, centered) / idx.shape[-1]
    normals = _smallest_eigenvector(cov)
    # orient toward the sensor at the origin: n . (0 - p) >= 0
    flip = _dot3(normals, -points.to(torch.float64)) < 0
    return torch.where(flip[..., None], -normals, normals)


def estimate_normals(points, mask, k: int = NORMAL_K):
    """(B, N, 3) float32 padded clouds, (B, N) valid flags -> (B, N, 3)
    float64 unit normals from the k nearest neighbours, in ``lax.top_k``
    order (fewer than k valid points fill up with masked ones, as in the
    JAX package), oriented toward the origin (the sensor)."""
    return _normals(points, _knn(points, mask, k)[0])


def _pair_features(p, n_p, q, n_q):
    """Darboux angle triplet (alpha, phi, theta) and distance for point
    pairs (broadcast over the leading axes)."""
    d = q - p
    dist = torch.sqrt(_dot3(d, d))
    d_unit = d / torch.clamp_min(dist, 1e-12)[..., None]
    u = n_p.expand_as(d_unit)
    v = _cross3(d_unit, u)
    v = v / torch.clamp_min(torch.sqrt(_dot3(v, v)), 1e-12)[..., None]
    w = _cross3(u, v)
    alpha = _dot3(v, n_q)                                  # [-1, 1]
    phi = _dot3(u, d_unit)                                 # [-1, 1]
    theta = torch.atan2(_dot3(w, n_q), _dot3(u, n_q))      # [-pi, pi]
    return alpha, phi, theta, dist


def _histogram(vals, lo, hi, weights):
    """(..., k) values -> (..., N_BINS) weighted histogram; a value's bin is
    the truncation of its scaled position, clipped to the range."""
    scaled = torch.nan_to_num((vals - lo) / (hi - lo) * N_BINS)
    b = torch.clamp(torch.trunc(scaled), 0, N_BINS - 1).to(torch.int64)
    out = torch.zeros(vals.shape[:-1] + (N_BINS,), dtype=weights.dtype,
                      device=vals.device)
    # 0/1 weights: the sums are exact in any order
    return out.scatter_add_(-1, b, weights)


def fpfh_features_batch(points, mask, radius: float, k: int = 32):
    """(B, N, 33) float64 FPFH descriptors and (B, N, 3) normals of padded
    float32 clouds (B, N, 3) with valid flags (B, N).

    k nearest neighbours gated by ``radius`` approximate the radius search
    (o3.KDTreeSearchParamHybrid(radius, max_nn), pointcloud.py:1197-1200).
    """
    # one neighbour search for both: the first NORMAL_K of a sorted list of
    # k are the NORMAL_K nearest
    idx = _knn(points, mask, max(k, NORMAL_K))[0]
    normals = _normals(points, idx[..., :NORMAL_K])
    idx = idx[..., :k]
    pts = points.to(torch.float64)
    neigh = _gather_rows(pts, idx)                 # (B, N, k, 3)
    neigh_n = _gather_rows(normals, idx)
    alpha, phi, theta, dist = _pair_features(
        pts[:, :, None, :], normals[:, :, None, :], neigh, neigh_n)
    neigh_mask = torch.gather(mask, 1, idx.reshape(idx.shape[0], -1))
    valid = (mask[:, :, None] & neigh_mask.reshape(idx.shape)
             & (dist > 1e-9) & (dist <= radius)).to(torch.float64)

    spfh = torch.cat([
        _histogram(alpha, -1.0, 1.0, valid),
        _histogram(phi, -1.0, 1.0, valid),
        _histogram(theta, -np.pi, np.pi, valid),
    ], dim=-1)  # (B, N, 33)
    counts = torch.clamp_min(valid.sum(dim=-1), 1.0)[..., None]
    spfh = spfh / counts * 100.0  # percentage bins like Open3D

    # FPFH(p) = SPFH(p) + mean_q (1/omega) SPFH(q), omega = |p - q|, summed
    # over the neighbours in order
    w_neigh = torch.where(valid > 0, 1.0 / torch.clamp_min(dist, 1e-6), 0.0)
    weighted = torch.zeros_like(spfh)
    for j in range(idx.shape[-1]):
        weighted += w_neigh[..., j, None] * gather_points(spfh, idx[..., j])
    return spfh + weighted / counts, normals


def fpfh_features(points, mask, radius: float, k: int = 32):
    """(N, 33) FPFH descriptors and (N, 3) normals of one padded cloud."""
    feat, normals = fpfh_features_batch(points[None], mask[None], radius, k)
    return feat[0], normals[0]


def _matches(feat_src, mask_src, feat_dst, mask_dst):
    """Nearest neighbours in feature space, both ways, over valid points:
    fwd (B, Ns) the dst match of each src point, bwd (B, Nd) the src match
    of each dst point; ties to the lower index, as ``jnp.argmin``."""
    b, ns, _ = feat_src.shape
    nd = feat_dst.shape[1]
    fs, fd = feat_src.to(torch.float64), feat_dst.to(torch.float64)
    sq_s, sq_d = (fs * fs).sum(-1), (fd * fd).sum(-1)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=fs.device)
    fwd, bwd = [], []
    step = _block(fs.device, ns * nd)
    for s in range(0, b, step):
        e = min(s + step, b)
        d2 = torch.baddbmm(sq_s[s:e, :, None] + sq_d[s:e, None, :],
                           fs[s:e], fd[s:e].mT, alpha=-2.0)
        d2 = torch.where(mask_src[s:e, :, None] & mask_dst[s:e, None, :],
                         d2, inf)
        fwd.append(torch.argmin(d2, dim=2))
        bwd.append(torch.argmin(d2, dim=1))
    return torch.cat(fwd), torch.cat(bwd)


def _feature_correspondences(feat_src, mask_src, feat_dst, mask_dst):
    """Nearest valid dst point in feature space of each src point, (B, N)."""
    return _matches(feat_src, mask_src, feat_dst, mask_dst)[0]


def pair_uniforms(seed: int, pair_ids, shape, device):
    """(B, *shape) float64 uniforms in [0, 1): row ``i`` from a numpy
    generator seeded with (seed, pair_ids[i]), so that a pair's draws
    depend on neither the device nor the other pairs of its batch."""
    u = np.stack([np.random.default_rng([int(seed), int(p)]).random(shape)
                  for p in pair_ids])
    return torch.as_tensor(u, dtype=torch.float64, device=device)


def rank_to_index(valid, ranks):
    """valid (B, N) bool, ranks (B, ...) int64 -> the index of the
    rank-th (0-based) valid entry of each row, clamped to N - 1."""
    b, n = valid.shape
    cum = torch.cumsum(valid.to(torch.int64), dim=1)
    idx = torch.searchsorted(cum, (ranks + 1).reshape(b, -1))
    return torch.clamp_max(idx, n - 1).reshape(ranks.shape)


def draw_without_replacement(valid, uniforms):
    """(B, N) bool, (B, K, n) uniforms -> (B, K, n) indices: for each of K
    hypotheses, n distinct valid entries drawn one after the other, each
    uniformly among those not yet drawn (the ``floor(u m)``-th of the m
    left). Integer arithmetic after the one float64 product, so every
    device draws alike."""
    m = valid.sum(dim=1).to(torch.float64)[:, None]            # (B, 1)
    picked = []
    for j in range(uniforms.shape[-1]):
        left = torch.clamp_min(m - j, 1.0)
        r = torch.minimum(torch.floor(uniforms[..., j] * left), left - 1)
        r = r.to(torch.int64)
        # the r-th rank not drawn yet: step over the drawn ranks in order
        if picked:
            drawn = torch.sort(torch.stack(picked, -1), dim=-1).values
            for prev in drawn.unbind(-1):
                r = r + (r >= prev).to(torch.int64)
        picked.append(r)
    return rank_to_index(valid, torch.stack(picked, dim=-1))


def _edge_lengths_ok(p, q, ratio: float):
    """(..., n, 3) sample points and their matches -> (...,) whether every
    edge of the sample keeps its length within ``ratio`` across the match
    (o3.CorrespondenceCheckerBasedOnEdgeLength)."""
    n = p.shape[-2]
    ok = torch.ones(p.shape[:-2], dtype=torch.bool, device=p.device)
    for i in range(n):
        for j in range(n):
            if i != j:
                dp = torch.sqrt(_dot3(p[..., i, :] - p[..., j, :],
                                      p[..., i, :] - p[..., j, :]))
                dq = torch.sqrt(_dot3(q[..., i, :] - q[..., j, :],
                                      q[..., i, :] - q[..., j, :]))
                ok &= (dp > ratio * dq) & (dq > ratio * dp)
    return ok


def _residuals(src, R, t, target):
    """|R src + t - target| for every hypothesis: src, target (b, N, 3),
    R (b, K, 3, 3), t (b, K, 3) -> (b, K, N), float64."""
    err2 = None
    for i in range(3):
        c = src[:, None, :, 0] * R[:, :, i, 0, None]
        c += src[:, None, :, 1] * R[:, :, i, 1, None]
        c += src[:, None, :, 2] * R[:, :, i, 2, None]
        c += t[:, :, i, None]
        c -= target[:, None, :, i]
        c.square_()
        err2 = c if err2 is None else err2.add_(c)
    return err2.sqrt_()


def ransac_registration_batch(src, src_mask, dst, dst_mask, src_feat,
                              dst_feat, distance_threshold: float,
                              num_hypotheses: int = 2048, ransac_n: int = 4,
                              with_constraint: bool = True,
                              edge_length_ratio: float = 0.9,
                              mutual_filter: bool = True, *, seed: int = 0,
                              pair_ids=None, picks=None):
    """Parallel-hypothesis RANSAC over feature correspondences, per pair of
    a batch of padded float32 clouds (B, N, 3) with their features.

    ``mutual_filter`` keeps only reciprocal feature matches (the pruning
    ``icp/fgr.py`` uses), falling back to the unpruned set when fewer than
    ``ransac_n`` reciprocal matches survive. ``picks`` (B, K, ransac_n)
    replaces the draws (indices into the src points); by default they come
    from ``pair_uniforms(seed, pair_ids)``, ``pair_ids`` defaulting to
    0..B-1. Hypotheses are scored in chunks of ``HYPOTHESIS_CHUNK``; the
    first of the best scores wins.

    Returns float64 tensors R (B, 3, 3), t (B, 3), fitness (B,),
    inlier_rmse (B,).
    """
    b, n, _ = src.shape
    dev = src.device
    corr, bwd = _matches(src_feat, src_mask, dst_feat, dst_mask)
    src64 = src.to(torch.float64)
    dst_corr = gather_points(dst.to(torch.float64), corr)      # (B, N, 3)
    corr_valid = src_mask & torch.gather(dst_mask, 1, corr)
    if mutual_filter:
        mutual = torch.gather(bwd, 1, corr) == torch.arange(n, device=dev)
        mutual_valid = corr_valid & mutual
        enough = mutual_valid.sum(dim=1) >= ransac_n
        corr_valid = torch.where(enough[:, None], mutual_valid, corr_valid)
    if picks is None:
        ids = range(b) if pair_ids is None else pair_ids
        picks = draw_without_replacement(corr_valid, pair_uniforms(
            seed, ids, (num_hypotheses, ransac_n), dev))
    picks = torch.as_tensor(picks, device=dev).to(torch.int64)
    k = picks.shape[1]
    solve = _estimate_yaw_translation if with_constraint else _estimate_full
    thr = float(distance_threshold)

    best_score = torch.full((b,), -2, dtype=torch.int64, device=dev)
    best_R = torch.eye(3, dtype=torch.float64, device=dev).repeat(b, 1, 1)
    best_t = torch.zeros((b, 3), dtype=torch.float64, device=dev)
    for h in range(0, k, HYPOTHESIS_CHUNK):
        kc = min(HYPOTHESIS_CHUNK, k - h)
        pk = picks[:, h:h + kc].reshape(b, kc * ransac_n)
        p = gather_points(src64, pk).reshape(b, kc, ransac_n, 3)
        q = gather_points(dst_corr, pk).reshape(b, kc, ransac_n, 3)
        ratio_ok = _edge_lengths_ok(p, q, edge_length_ratio)
        R, t = solve(p.reshape(b * kc, ransac_n, 3),
                     q.reshape(b * kc, ransac_n, 3),
                     torch.ones((b * kc, ransac_n), dtype=torch.float64,
                                device=dev))
        R, t = R.reshape(b, kc, 3, 3), t.reshape(b, kc, 3)
        step = _block(dev, kc * n)
        for s in range(0, b, step):
            e = min(s + step, b)
            err = _residuals(src64[s:e], R[s:e], t[s:e], dst_corr[s:e])
            inlier = corr_valid[s:e, None, :] & (err < thr)
            del err
            score = torch.where(ratio_ok[s:e], inlier.sum(dim=-1), -1)
            del inlier
            top = torch.argmax(score, dim=1)        # first of the best
            top_score = torch.gather(score, 1, top[:, None])[:, 0]
            # a later chunk wins only with a strictly higher score
            better = top_score > best_score[s:e]
            rows = torch.arange(e - s, device=dev)
            best_score[s:e] = torch.where(better, top_score, best_score[s:e])
            best_R[s:e] = torch.where(better[:, None, None], R[s:e][rows, top],
                                      best_R[s:e])
            best_t[s:e] = torch.where(better[:, None], t[s:e][rows, top],
                                      best_t[s:e])

    # final inlier stats
    err = _residuals(src64, best_R[:, None], best_t[:, None], dst_corr)[:, 0]
    inlier = (corr_valid & (err < thr)).to(torch.float64)
    n_in = inlier.sum(dim=1)
    fitness = n_in / torch.clamp_min(corr_valid.to(torch.float64).sum(1), 1.0)
    rmse = torch.sqrt((inlier * err * err).sum(1) / torch.clamp_min(n_in, 1.0))
    return best_R, best_t, fitness, rmse


def ransac_registration(src, src_mask, dst, dst_mask, src_feat, dst_feat,
                        distance_threshold: float, num_hypotheses: int = 2048,
                        ransac_n: int = 4, with_constraint: bool = True,
                        edge_length_ratio: float = 0.9,
                        mutual_filter: bool = True, *, seed: int = 0,
                        pair_id: int = 0, picks=None):
    """``ransac_registration_batch`` for ONE pair ((N, 3) clouds, picks
    (K, ransac_n)); returns R (3, 3), t (3,), fitness, inlier_rmse."""
    out = ransac_registration_batch(
        src[None], src_mask[None], dst[None], dst_mask[None], src_feat[None],
        dst_feat[None], distance_threshold, num_hypotheses=num_hypotheses,
        ransac_n=ransac_n, with_constraint=with_constraint,
        edge_length_ratio=edge_length_ratio, mutual_filter=mutual_filter,
        seed=seed, pair_ids=[pair_id],
        picks=None if picks is None else torch.as_tensor(picks)[None])
    return tuple(x[0] for x in out)


def global_registration_batch(src, src_mask, dst, dst_mask,
                              voxel_size: float = 0.05, seed: int = 0,
                              method: str = "ransac",
                              with_constraint: bool = True,
                              max_points: int = 2048,
                              num_hypotheses: int = 2048,
                              mutual_filter: bool = True, *, pair_ids=None,
                              device: torch.device | str):
    """Batched FPFH global registration of a chunk of padded pairs (numpy
    (B, N, 3) clouds and (B, N) masks) on ``device``.

    ``method``: 'ransac' (reference icp_o3_gicp, icp.py:85-105) or 'fgr'
    (reference icp_o3_gicp_fast, icp.py:121-143; ``icp/fgr.py``). The
    draws of pair i come from (``seed``, ``pair_ids[i]``), by default
    0..B-1. Returns numpy (transforms (B,4,4) float64, fitness, rmse).
    """
    radius_feature = voxel_size * 5.0
    distance_threshold = voxel_size * 1.5
    sp, sm = prep_downsampled_batch(src, src_mask, voxel_size, max_points)
    dp, dm = prep_downsampled_batch(dst, dst_mask, voxel_size, max_points)
    sp, sm, dp, dm = (torch.as_tensor(x, device=device)
                      for x in (sp, sm, dp, dm))
    sf, _ = fpfh_features_batch(sp, sm, radius_feature)
    df, _ = fpfh_features_batch(dp, dm, radius_feature)
    if method == "ransac":
        R, t, fit, rmse = ransac_registration_batch(
            sp, sm, dp, dm, sf, df, distance_threshold,
            num_hypotheses=num_hypotheses, with_constraint=with_constraint,
            mutual_filter=mutual_filter, seed=seed, pair_ids=pair_ids)
    elif method == "fgr":
        from alignnet3d_tpu_torch.icp.fgr import fgr_batch

        R, t, fit, rmse = fgr_batch(
            sp, sm, dp, dm, sf, df, with_constraint=with_constraint,
            distance_threshold=distance_threshold, seed=seed,
            pair_ids=pair_ids)
    else:
        raise ValueError(f"unknown global registration method {method!r}")
    out = np.tile(np.eye(4), (len(sp), 1, 1))
    out[:, :3, :3] = R.cpu().numpy()
    out[:, :3, 3] = t.cpu().numpy()
    return out, fit.cpu().numpy(), rmse.cpu().numpy()


def fpfh_ransac_pair(src_full: np.ndarray, dst_full: np.ndarray,
                     voxel_size: float = 0.05, seed: int = 0,
                     num_hypotheses: int = 2048,
                     with_constraint: bool = True,
                     max_points: int = 2048, *,
                     device: torch.device | str):
    """Full pipeline for one pair of raw clouds (reference icp_o3_gicp,
    icp.py:85-105): downsample, features, RANSAC. Returns (4x4, fitness,
    rmse)."""
    out, fit, rmse = global_registration_batch(
        [np.asarray(src_full, np.float32)], None,
        [np.asarray(dst_full, np.float32)], None, voxel_size=voxel_size,
        seed=seed, with_constraint=with_constraint, max_points=max_points,
        num_hypotheses=num_hypotheses, device=device)
    return out[0], float(fit[0]), float(rmse[0])
