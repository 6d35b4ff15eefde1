"""Fast Global Registration over a batch of padded pairs.

Counterpart of ``alignnet3d_tpu/icp/fgr.py``, the algorithm behind the
reference's ``icp_o3_gicp_fast`` variant (reference icp.py:121-143; Zhou,
Park & Koltun, "Fast Global Registration", ECCV 2016):

1. reciprocal nearest neighbours in FPFH space;
2. the tuple test: ``num_tuples`` random triplets of matches, drawn with
   replacement; a triplet passes when its three edge-length ratios lie in
   (tau, 1/tau), and a match survives when a passing triplet uses it;
3. graduated non-convexity over the scaled Geman-McClure penalty: mu
   starts at the squared diameter of the source cloud and is divided by
   ``division_factor`` every 4 iterations, floored at the distance
   threshold squared; each iteration weighs the matches by
   (mu / (mu + r^2))^2 and solves the weighted rigid update in closed form
   (yaw + translation under the constraint, Kabsch without).

The pose algebra runs in float64, as in ``icp/p2point.py``. The triplets
of pair i come from uniforms made on the host from (seed, pair_ids[i])
(``fpfh.pair_uniforms``): a draw picks the ``floor(u m)``-th of the m
reciprocal matches, the law of ``jax.random.choice(replace=True,
p=mask / sum)``.
"""

from __future__ import annotations

import torch

from alignnet3d_tpu_torch.icp.fpfh import (
    _dot3,
    _matches,
    pair_uniforms,
    rank_to_index,
)
from alignnet3d_tpu_torch.icp.p2point import (
    _estimate_full,
    _estimate_yaw_translation,
    gather_points,
)


def _mutual_correspondences(feat_src, mask_src, feat_dst, mask_dst):
    """Reciprocal nearest-neighbour matches in feature space.

    Returns (idx (B, N), valid (B, N) bool): src point i matches dst point
    idx[i]; valid where the match is mutual and both points are real.
    """
    fwd, bwd = _matches(feat_src, mask_src, feat_dst, mask_dst)
    n = feat_src.shape[1]
    mutual = torch.gather(bwd, 1, fwd) == torch.arange(n, device=fwd.device)
    valid = mask_src & torch.gather(mask_dst, 1, fwd) & mutual
    return fwd, valid


def draw_with_replacement(valid, uniforms):
    """(B, N) bool, (B, ...) uniforms -> (B, ...) indices of valid entries,
    each uniform among them (the ``floor(u m)``-th of m)."""
    m = valid.sum(dim=1).to(torch.float64)
    m = m.reshape((-1,) + (1,) * (uniforms.dim() - 1))
    r = torch.minimum(torch.floor(uniforms * m), torch.clamp_min(m - 1, 0.0))
    return rank_to_index(valid, r.to(torch.int64))


def _tuple_test(p, q, valid, num_tuples: int, tau: float, *, uniforms=None,
                picks=None):
    """Keep the matches that appear in at least one edge-ratio-consistent
    random triplet (paper §5; o3 AdvancedMatching tuple test).

    p, q (B, N, 3) matched points, valid (B, N) bool. ``picks`` (B, T, 3)
    replaces the draws; otherwise they come from ``uniforms`` (B, T, 3).
    Returns (B, N) bool."""
    if picks is None:
        picks = draw_with_replacement(valid, uniforms)
    picks = torch.as_tensor(picks, device=p.device).to(torch.int64)
    b, t, _ = picks.shape
    flat = picks.reshape(b, t * 3)
    pi = gather_points(p, flat).reshape(b, t, 3, 3)
    qi = gather_points(q, flat).reshape(b, t, 3, 3)
    ok = torch.ones((b, t), dtype=torch.bool, device=p.device)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        ep, eq = pi[:, :, i] - pi[:, :, j], qi[:, :, i] - qi[:, :, j]
        dp, dq = torch.sqrt(_dot3(ep, ep)), torch.sqrt(_dot3(eq, eq))
        r = dp / torch.clamp_min(dq, 1e-12)
        ok &= (r > tau) & (r < 1.0 / tau)
    # all three picked matches must be real
    ok &= torch.gather(valid, 1, flat).reshape(b, t, 3).all(dim=-1)
    # scatter-or: a match survives if any passing triplet uses it
    hits = torch.zeros(valid.shape, dtype=torch.int64, device=p.device)
    hits.scatter_add_(1, flat, ok.repeat_interleave(3, dim=1).to(torch.int64))
    return valid & (hits > 0)


def fgr_batch(src, src_mask, dst, dst_mask, feat_src, feat_dst,
              iters: int = 64, division_factor: float = 1.4,
              tau: float = 0.9, num_tuples: int = 1000,
              with_constraint: bool = True,
              distance_threshold: float = 0.075, *, seed: int = 0,
              pair_ids=None, picks=None):
    """FGR for a batch of padded pairs: float32 clouds (B, N, 3), masks
    (B, N), features (B, N, F). ``picks`` (B, num_tuples, 3) replaces the
    tuple test's draws. Returns float64 tensors R (B, 3, 3), t (B, 3),
    fitness (B,), inlier_rmse (B,)."""
    b = src.shape[0]
    dev = src.device
    corr_idx, corr_valid = _mutual_correspondences(feat_src, src_mask,
                                                   feat_dst, dst_mask)
    src64 = src.to(torch.float64)
    q_all = gather_points(dst.to(torch.float64), corr_idx)
    uniforms = None
    if picks is None:
        uniforms = pair_uniforms(seed, range(b) if pair_ids is None
                                 else pair_ids, (num_tuples, 3), dev)
    keep = _tuple_test(src64, q_all, corr_valid, num_tuples, tau,
                       uniforms=uniforms, picks=picks)
    # fall back to the mutual set if the tuple test annihilates everything
    keep = torch.where((keep.sum(dim=1) >= 3)[:, None], keep, corr_valid)

    # mu_init = squared diameter of the source cloud (paper §4)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    lo = torch.where(src_mask[..., None], src64, inf).amin(dim=1)
    hi = torch.where(src_mask[..., None], src64, -inf).amax(dim=1)
    diam2 = ((hi - lo) ** 2).sum(dim=1)
    mu = torch.clamp_min(diam2, 1e-6)
    floor = float(distance_threshold) ** 2

    base_w = keep.to(torch.float64)
    solve = _estimate_yaw_translation if with_constraint else _estimate_full
    R = torch.eye(3, dtype=torch.float64, device=dev).repeat(b, 1, 1)
    t = torch.zeros((b, 3), dtype=torch.float64, device=dev)
    eye = torch.eye(3, dtype=torch.float64, device=dev).expand_as(R)
    for it in range(iters):
        moved = torch.einsum("bnd,bed->bne", src64, R) + t[:, None, :]
        r2 = ((moved - q_all) ** 2).sum(dim=-1)
        w = base_w * (mu[:, None] / (mu[:, None] + r2)) ** 2
        R_inc, t_inc = solve(moved, q_all, w)
        has = w.sum(dim=1) > 1e-9
        R_inc = torch.where(has[:, None, None], R_inc, eye)
        t_inc = torch.where(has[:, None], t_inc, torch.zeros_like(t_inc))
        R, t = R_inc @ R, torch.einsum("bij,bj->bi", R_inc, t) + t_inc
        # graduated non-convexity schedule: anneal every 4 iterations
        if (it + 1) % 4 == 0:
            mu = mu / division_factor
        mu = torch.clamp_min(mu, floor)

    # final inlier stats over the kept match set
    moved = torch.einsum("bnd,bed->bne", src64, R) + t[:, None, :]
    err2 = ((moved - q_all) ** 2).sum(dim=-1)
    inlier = base_w * (err2 < floor)
    n_in = inlier.sum(dim=1)
    fitness = n_in / torch.clamp_min(base_w.sum(dim=1), 1.0)
    rmse = torch.sqrt((inlier * err2).sum(dim=1) / torch.clamp_min(n_in, 1.0))
    return R, t, fitness, rmse
