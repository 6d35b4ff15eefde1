"""Batched point-to-point ICP with the ground-plane constraint.

Counterpart of the constrained path of ``alignnet3d_tpu/icp/p2point.py``
(reference icp.py:69-143 with the forked Open3D ``with_constraint`` flag).
Every pair of the batch runs at once: each iteration finds each source
point's nearest destination point (``nn_argmin``, the CUDA kernel on the
card), keeps the correspondences inside the radius, and solves the
weighted yaw + translation update in closed form. Clouds are padded to a
common length; padded points never become correspondences.
"""

from __future__ import annotations

import numpy as np
import torch

from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin


def _nn_correspondences(src, dst, dst_mask):
    """(B, n1, 3), (B, n2, 3), (B, n2) -> index (B, n1) and squared
    distance (B, n1) of each source point's nearest valid dst point."""
    return nn_argmin(src.contiguous(), dst.contiguous(), dst_mask.contiguous())


def _estimate_yaw_translation(p, q, w):
    """Weighted closed-form (yaw, translation) minimising
    sum w |Rz(yaw) p + t - q|^2 per pair: (B, n, 3), (B, n, 3), (B, n) ->
    R (B, 3, 3), t (B, 3)."""
    wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:, None]
    p_bar = torch.sum(w[..., None] * p, dim=1) / wsum
    q_bar = torch.sum(w[..., None] * q, dim=1) / wsum
    a = p - p_bar[:, None, :]
    b = q - q_bar[:, None, :]
    num = torch.sum(w * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), dim=1)
    den = torch.sum(w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]), dim=1)
    yaw = torch.atan2(num, den)
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    t = q_bar - torch.einsum("bij,bj->bi", R, p_bar)
    return R, t


def _gate(src_mask, d2, radius2):
    return (src_mask & (d2 < radius2)).to(torch.float64)


def icp_p2point_batch(src, src_mask, dst, dst_mask, init_transforms,
                      radius: float = 0.2, its: int = 30,
                      with_constraint: bool = True, *,
                      device: torch.device | str):
    """Batched point-to-point ICP on ``device``.

    Args:
      src, dst: (B, N, 3) padded clouds; masks (B, N) bool valid flags.
      init_transforms: (B, 4, 4) initial guesses.
      radius: correspondence gate; its: fixed iteration count.
    Returns (transforms (B,4,4) float64, fitness (B,), inlier_rmse (B,)),
    numpy.
    """
    if not with_constraint:
        raise NotImplementedError(
            "unconstrained ICP (_estimate_full) is not ported yet (ROADMAP.md, "
            "Queue 1)")

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    # the pose algebra runs in float64: in float32 the closed-form update's
    # sums over thousands of points round differently on the card and on
    # the CPU, and ICP from a poor start amplifies such last-bit gaps into
    # different answers. The nearest-neighbour search stays float32.
    src64 = dev(src, torch.float64)
    dst32 = dev(dst, torch.float32).contiguous()
    dst64 = dst32.to(torch.float64)
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
        q = torch.gather(dst64, 1, idx[..., None].expand(-1, -1, 3))
        R_inc, t_inc = _estimate_yaw_translation(moved, q, w)
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
