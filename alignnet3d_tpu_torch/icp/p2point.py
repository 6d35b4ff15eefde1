"""Batched point-to-point ICP, with or without the ground-plane constraint,
and the eval-time refinement of network predictions.

Counterpart of ``alignnet3d_tpu/icp/p2point.py`` (reference icp.py:69-143
with the forked Open3D ``with_constraint`` flag). Every pair of the batch
runs at once: each iteration finds each source point's nearest destination
point (``nn_argmin``, the CUDA kernel on the card), keeps the
correspondences inside the radius, and solves the weighted update in closed
form: yaw + translation under the constraint, a 3x3 Kabsch SVD without it.
Clouds are padded to a common length; padded points never become
correspondences.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from alignnet3d_tpu_torch.geometry import get_mat_angle
from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin

logger = logging.getLogger("alignnet3d_tpu_torch")


def _nn_correspondences(src, dst, dst_mask):
    """(B, n1, 3), (B, n2, 3), (B, n2) -> index (B, n1) and squared
    distance (B, n1) of each source point's nearest valid dst point."""
    return nn_argmin(src.contiguous(), dst.contiguous(), dst_mask.contiguous())


def _weighted_means(p, q, w):
    wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:, None]
    return (torch.sum(w[..., None] * p, dim=1) / wsum,
            torch.sum(w[..., None] * q, dim=1) / wsum)


def _rot_z(yaw):
    """(B,) angles -> (B, 3, 3) rotations about +z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def _estimate_yaw_translation(p, q, w):
    """Weighted closed-form (yaw, translation) minimising
    sum w |Rz(yaw) p + t - q|^2 per pair: (B, n, 3), (B, n, 3), (B, n) ->
    R (B, 3, 3), t (B, 3)."""
    p_bar, q_bar = _weighted_means(p, q, w)
    a = p - p_bar[:, None, :]
    b = q - q_bar[:, None, :]
    num = torch.sum(w * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), dim=1)
    den = torch.sum(w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]), dim=1)
    R = _rot_z(torch.atan2(num, den))
    t = q_bar - torch.einsum("bij,bj->bi", R, p_bar)
    return R, t


def _estimate_full(p, q, w):
    """Unconstrained weighted Kabsch per pair (batched 3x3 SVD, with the
    determinant's sign fix against reflections)."""
    p_bar, q_bar = _weighted_means(p, q, w)
    H = torch.einsum("bn,bni,bnj->bij", w, p - p_bar[:, None, :],
                     q - q_bar[:, None, :])
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ U.mT
    t = q_bar - torch.einsum("bij,bj->bi", R, p_bar)
    return R, t


def _gate(src_mask, d2, radius2):
    return (src_mask & (d2 < radius2)).to(torch.float64)


def run_icp(src, src_mask, dst, dst_mask, init_transforms, radius, its,
            estimate, *, device):
    """The ICP loop shared by the point-to-point and point-to-plane
    variants. ``estimate(moved, idx, w)`` returns the per-pair increment
    (R (B,3,3), t (B,3)) in float64 from the moved source points, the
    nearest-neighbour indices and the radius-gate weights. Returns numpy
    (transforms (B,4,4) float64, fitness (B,), inlier_rmse (B,))."""
    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    # the pose algebra runs in float64: in float32 the closed-form update's
    # sums over thousands of points round differently on the card and on
    # the CPU, and ICP from a poor start amplifies such last-bit gaps into
    # different answers. The nearest-neighbour search stays float32.
    src64 = dev(src, torch.float64)
    dst32 = dev(dst, torch.float32).contiguous()
    sm = dev(src_mask, torch.bool)
    dm = dev(dst_mask, torch.bool).contiguous()
    init = np.asarray(init_transforms, np.float64)
    R = dev(init[:, :3, :3], torch.float64)
    t = dev(init[:, :3, 3], torch.float64)
    # the radius is squared in float32, as the JAX package does
    radius2 = float(np.float32(radius) * np.float32(radius))
    eye = torch.eye(3, dtype=torch.float64, device=R.device).expand_as(R)

    def moved_by(R, t):
        return torch.einsum("bnd,bed->bne", src64, R) + t[:, None, :]

    for _ in range(its):
        moved = moved_by(R, t)
        idx, d2 = _nn_correspondences(moved.to(torch.float32), dst32, dm)
        w = _gate(sm, d2, radius2)
        R_inc, t_inc = estimate(moved, idx, w)
        # no correspondences -> keep the current transform
        has = (torch.sum(w, dim=1) > 0)
        R_inc = torch.where(has[:, None, None], R_inc, eye)
        t_inc = torch.where(has[:, None], t_inc, torch.zeros_like(t_inc))
        R, t = R_inc @ R, torch.einsum("bij,bj->bi", R_inc, t) + t_inc

    _, d2 = _nn_correspondences(moved_by(R, t).to(torch.float32), dst32, dm)
    d2 = d2.to(torch.float64)
    inlier = _gate(sm, d2, radius2)
    n_src = torch.clamp_min(torch.sum(sm.to(torch.float64), dim=1), 1.0)
    n_in = torch.sum(inlier, dim=1)
    fitness = (n_in / n_src).to(torch.float32)
    rmse = torch.sqrt(torch.sum(inlier * d2, dim=1)
                      / torch.clamp_min(n_in, 1.0)).to(torch.float32)

    out = np.tile(np.eye(4, dtype=np.float64), (len(init), 1, 1))
    out[:, :3, :3] = R.cpu().numpy()
    out[:, :3, 3] = t.cpu().numpy()
    return out, fitness.cpu().numpy(), rmse.cpu().numpy()


def gather_points(points, idx):
    """points (B, n, C), idx (B, m) -> (B, m, C)."""
    return torch.gather(points, 1, idx[..., None].expand(-1, -1,
                                                         points.shape[-1]))


def icp_p2point_batch(src, src_mask, dst, dst_mask, init_transforms,
                      radius: float = 0.2, its: int = 30,
                      with_constraint: bool = True, *,
                      device: torch.device | str):
    """Batched point-to-point ICP on ``device``.

    Args:
      src, dst: (B, N, 3) padded clouds; masks (B, N) bool valid flags.
      init_transforms: (B, 4, 4) initial guesses.
      radius: correspondence gate; its: fixed iteration count.
      with_constraint: yaw + translation only (the ground-plane
        constraint); False estimates a full rotation.
    Returns (transforms (B,4,4) float64, fitness (B,), inlier_rmse (B,)),
    numpy.
    """
    dst64 = torch.as_tensor(np.asarray(dst, np.float32),
                            device=device).to(torch.float64)
    solve = _estimate_yaw_translation if with_constraint else _estimate_full

    def estimate(moved, idx, w):
        return solve(moved, gather_points(dst64, idx), w)

    return run_icp(src, src_mask, dst, dst_mask, init_transforms, radius, its,
                   estimate, device=device)


# ----------------------------------------------------------- cloud batching


def pad_full_clouds(dataset, file_indices, max_points: int = 4096,
                    seed: int = 0, pad_to: int | None = None):
    """The FULL (not resampled) clouds of the given samples as padded
    (B, N, 3) arrays + masks; clouds above ``max_points`` are subsampled
    without replacement from a generator seeded with ``seed``.

    ``pad_to`` fixes the padded length (a dataset-global cap, so that every
    chunk has one shape); by default the chunk's own largest count."""
    rng = np.random.default_rng(seed)
    rows = dataset.rows(file_indices)
    n_cap = pad_to if pad_to is not None else max(1, min(max_points, int(max(
        dataset.counts1[rows].max(initial=1),
        dataset.counts2[rows].max(initial=1)))))
    out = []
    for k in (1, 2):
        counts = getattr(dataset, f"counts{k}")[rows]
        offsets = getattr(dataset, f"offsets{k}")[rows]
        points = getattr(dataset, f"points{k}")
        b = len(rows)
        arr = np.zeros((b, n_cap, 3), np.float32)
        mask = np.zeros((b, n_cap), bool)
        for i in range(b):
            c = int(counts[i])
            pts = points[offsets[i]: offsets[i] + c]
            if c > n_cap:
                pts = pts[rng.choice(c, n_cap, replace=False)]
                c = n_cap
            arr[i, :c] = pts
            mask[i, :c] = True
        out.append((arr, mask))
    return out[0], out[1]


def refine_predictions(cfg, val_idxs, pred_translations, pred_angles,
                       pred_centers, its: int = 30, radius: float = 0.1,
                       dataset=None, pair_chunk: int = 128,
                       max_points: int = 4096, gate: bool = False,
                       gate_max_dyaw_deg: float = 15.0,
                       gate_max_dxy: float = 0.5,
                       method: str = "p2p", *,
                       device: torch.device | str):
    """ICP-refine network predictions over the whole val set (reference
    train.py:461-484), ``pair_chunk`` pairs at a time, every chunk padded
    to one dataset-global length.

    The initial transforms are ``get_mat_angle(t, a, rotation_center=c)``
    (reference train.py:465-467). ``method`` is 'p2p' (constrained
    point-to-point) or 'p2plane' (``icp/p2plane.py``).

    ``gate`` (evaluation.refinement_gate): keep the refined transform of a
    pair only when it scores better than the init on the radius-gated
    registration quality (fitness up by more than 1e-9, or equal fitness
    and inlier RMSE not up; the init's score comes from a 0-iteration
    constrained point-to-point call for both methods) and stays inside the
    trust region |dyaw| <= gate_max_dyaw_deg, |dxy| <= gate_max_dxy around
    the init. Otherwise the pair keeps its init.

    Returns ({"translations" (n,3), "angles" (n,1), "accepted" (n,) bool},
    seconds spent in ICP and the gate). The world-frame pose has its
    rotation centre at the origin; ``accepted`` is all True without the
    gate.
    """
    if method == "p2plane":
        from alignnet3d_tpu_torch.icp.p2plane import icp_p2plane_batch

        def icp_fn(*args, **kwargs):
            return icp_p2plane_batch(*args, **kwargs, device=device)
    elif method == "p2p":
        def icp_fn(*args, **kwargs):
            return icp_p2point_batch(*args, **kwargs, with_constraint=True,
                                     device=device)
    else:
        raise ValueError(f"unknown refinement method {method!r}")

    if dataset is None:
        from alignnet3d_tpu_torch.data.provider import PackedDataset

        dataset = PackedDataset(cfg.data.basepath)
    n = len(val_idxs)
    rows = dataset.rows(val_idxs)
    global_pad = max(1, min(max_points, int(max(
        dataset.counts1[rows].max(initial=1),
        dataset.counts2[rows].max(initial=1)))))
    out_t = np.empty((n, 3), np.float32)
    out_a = np.empty((n, 1), np.float32)
    accepted = np.ones(n, bool)
    elapsed = 0.0
    for s in range(0, n, pair_chunk):
        e = min(s + pair_chunk, n)
        (src, src_mask), (dst, dst_mask) = pad_full_clouds(
            dataset, val_idxs[s:e], max_points=max_points, pad_to=global_pad)
        init = np.stack([
            get_mat_angle(pred_translations[i], pred_angles[i],
                          rotation_center=pred_centers[i])
            for i in range(s, e)])
        t0 = time.time()
        tf, fit, rmse = icp_fn(src, src_mask, dst, dst_mask, init,
                               radius=radius, its=its)
        if gate:
            # score the INIT with a 0-iteration pass (same NN/radius gate)
            tf0, fit0, rmse0 = icp_p2point_batch(
                src, src_mask, dst, dst_mask, init, radius=radius, its=0,
                with_constraint=True, device=device)
            yaw = np.arctan2(tf[:, 1, 0], tf[:, 0, 0])
            yaw0 = np.arctan2(tf0[:, 1, 0], tf0[:, 0, 0])
            dyaw = np.abs(np.rad2deg((yaw - yaw0 + np.pi) % (2 * np.pi)
                                     - np.pi))
            dxy = np.linalg.norm(tf[:, :2, 3] - tf0[:, :2, 3], axis=1)
            better = (fit > fit0 + 1e-9) | (
                (fit >= fit0 - 1e-9) & (rmse <= rmse0 + 1e-9))
            accept = better & (dyaw <= gate_max_dyaw_deg) & (
                dxy <= gate_max_dxy)
            tf = np.where(accept[:, None, None], tf, tf0)
            accepted[s:e] = accept
        elapsed += time.time() - t0
        out_t[s:e] = tf[:, :3, 3]
        out_a[s:e, 0] = np.arctan2(tf[:, 1, 0], tf[:, 0, 0])
    if gate:
        logger.info(f"ICP ({method}, radius {radius}, {its} its) gate: "
                    f"accepted {int(accepted.sum())}/{n} (gate "
                    f"{gate_max_dyaw_deg} deg / {gate_max_dxy} m)")
    return {"translations": out_t, "angles": out_a,
            "accepted": accepted}, elapsed


def multistart_global_registration(src, src_mask, dst, dst_mask,
                                   num_yaw_hypotheses: int = 16,
                                   coarse_its: int = 15,
                                   refine_its: int = 30,
                                   coarse_radius: float = 1.0,
                                   radius: float = 0.1, *,
                                   device: torch.device | str):
    """Registration without an init, by a parallel yaw multi-start: K yaw
    hypotheses about the source centroid, each with the centroid-difference
    translation (reference get_centroid_init, icp.py:62-66), run coarse
    constrained ICP in one batch; the hypothesis with the best fitness
    (ties to the lower RMSE) is refined. It takes the place of the
    reference's FPFH + RANSAC / FGR (icp.py:85-143): the problem's rotation
    space is a circle, so it is enumerated."""
    b = src.shape[0]
    yaws = np.linspace(-np.pi, np.pi, num_yaw_hypotheses, endpoint=False)
    m1 = np.asarray(src_mask, bool)[..., None]
    m2 = np.asarray(dst_mask, bool)[..., None]
    c1 = ((np.asarray(src, np.float64) * m1).sum(1)
          / np.maximum(m1.sum(1), 1))
    c2 = ((np.asarray(dst, np.float64) * m2).sum(1)
          / np.maximum(m2.sum(1), 1))
    K = num_yaw_hypotheses
    inits = np.empty((b, K, 4, 4))
    for j, yaw in enumerate(yaws):
        for i in range(b):
            inits[i, j] = get_mat_angle(c2[i] - c1[i], yaw,
                                        rotation_center=c1[i])

    # coarse pass: the hypotheses flattened into the batch axis
    def rep(x):
        return np.repeat(x, K, axis=0)

    tf, fit, rmse = icp_p2point_batch(
        rep(src), rep(src_mask), rep(dst), rep(dst_mask),
        inits.reshape(b * K, 4, 4), radius=coarse_radius, its=coarse_its,
        device=device)
    score = fit.reshape(b, K) - 0.1 * rmse.reshape(b, K)
    best = np.argmax(score, axis=1)
    best_tf = tf.reshape(b, K, 4, 4)[np.arange(b), best]
    return icp_p2point_batch(src, src_mask, dst, dst_mask, best_tf,
                             radius=radius, its=refine_its, device=device)
