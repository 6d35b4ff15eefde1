"""Batched ground-plane-constrained point-to-plane ICP.

Counterpart of ``alignnet3d_tpu/icp/p2plane.py``, which fills the
reference's asserted-out ``p2plane`` variant (reference icp.py:81-83).
Point-to-plane minimises the residual projected on the destination's
surface normal, so sliding along a panel costs nothing and two sparse
resamplings of one surface stop fighting the estimate.

- Normals are estimated once per destination cloud from the covariance of
  its k nearest valid neighbours; the smallest eigenvector comes from 4
  steps of inverse iteration (no orientation: the cost is sign-invariant).
- Each iteration: nearest neighbours by ``nn_argmin`` (the CUDA kernel on
  the card), the radius gate, then a damped 4x4 normal-equation solve for
  the constrained increment (yaw theta about the weighted source centroid
  and a 3-D translation), linearised in theta.
- Fitness and inlier RMSE are point-to-POINT, as ``icp_p2point_batch``
  reports them, so the refinement gate scores both methods on one scale.
"""

from __future__ import annotations

import numpy as np
import torch

from alignnet3d_tpu_torch.icp.p2point import (
    _rot_z,
    gather_points,
    run_icp,
)
from alignnet3d_tpu_torch.ops.nn_kernels import _sq_norm

KNN_CHUNK = 512   # rows of the (rows, n) squared-distance block
_INVALID = 1e30   # added to the squared distance of a masked column


def _knn(points, mask, k: int):
    """The k nearest columns of every point of each padded cloud, in
    ``lax.top_k`` order: ascending squared distance, ties to the lower
    index. Masked columns sit at ``_INVALID`` + d2. Returns idx (B, n, k)
    int64 and d2 (B, n, k) float32."""
    b, n, _ = points.shape
    invalid = torch.where(mask, 0.0, _INVALID).to(torch.float32)
    sq = _sq_norm(points)
    # columns as -2q, (B, 3, n): the cross term is the JAX package's
    # -2 a.q, summed as ((a0 q0' + a1 q1') + a2 q2') with every step rounded
    # on its own, as nn_argmin_plain sums it: a matmul rounds differently
    # on the card and on the CPU, and at |a|^2 ~ 400 m^2 (ulp 3e-5) that
    # reorders near-tied neighbours
    qm = (-2.0 * points).permute(0, 2, 1).contiguous()
    q0, q1, q2 = qm[:, 0, None, :], qm[:, 1, None, :], qm[:, 2, None, :]
    cols = torch.arange(n, dtype=torch.int64, device=points.device)
    idx_parts, d2_parts = [], []
    for s in range(0, n, KNN_CHUNK):
        a = points[:, s:s + KNN_CHUNK]
        d2 = a[..., 0, None] * q0
        tmp = torch.mul(a[..., 1, None], q1)
        d2 += tmp
        torch.mul(a[..., 2, None], q2, out=tmp)
        d2 += tmp
        d2 += sq[:, s:s + KNN_CHUNK, None]
        d2 += sq[:, None, :]
        # the + 0.0 of a valid column turns a -0.0 into +0.0
        d2.clamp_(min=0.0)
        d2 += invalid[:, None, :]
        del tmp
        # a non-negative float32 orders as its bit pattern: one int64 key
        # (distance bits, column) sorts by distance, ties to the lower index
        key = (d2.view(torch.int32).to(torch.int64) << 32) | cols
        top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        idx_parts.append(top & 0xFFFFFFFF)
        d2_parts.append((top >> 32).to(torch.int32).view(torch.float32))
    return torch.cat(idx_parts, dim=1), torch.cat(d2_parts, dim=1)


def _adjugate_sym(M):
    """Adjugate of symmetric (..., 3, 3) matrices: det(M) M^-1."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    r0 = torch.stack([d * f - e * e, c * e - b * f, b * e - c * d], dim=-1)
    r1 = torch.stack([c * e - b * f, a * f - c * c, b * c - a * e], dim=-1)
    r2 = torch.stack([b * e - c * d, b * c - a * e, a * d - b * b], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def estimate_normals_batch(points, mask, k: int = 16, *,
                           device: torch.device | str):
    """(B, n, 3) padded clouds, (B, n) valid flags -> (B, n, 3) float32 unit
    normals, as a tensor on ``device``.

    Masked points never enter a neighbourhood; a point with fewer than 3
    valid neighbours gets an arbitrary finite unit normal. The covariance
    and the inverse iteration run in float64; the neighbour search in
    float32, as the JAX package's."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    msk = torch.as_tensor(np.asarray(mask, bool), device=device)
    idx, d2 = _knn(pts, msk, int(k))
    b, n, kk = idx.shape
    nbrs = gather_points(pts.to(torch.float64), idx.reshape(b, n * kk))
    nbrs = nbrs.reshape(b, n, kk, 3)
    w = (d2 < _INVALID / 2).to(torch.float64)           # valid neighbours
    wsum = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
    mu = torch.sum(nbrs * w[..., None], dim=2) / wsum      # (B, n, 3)
    cen = (nbrs - mu[:, :, None, :]) * w[..., None]
    cov = torch.einsum("bnki,bnkj->bnij", cen, cen) / wsum[..., None]
    # smallest eigenvector by INVERSE iteration on cov + eps I: near-planar
    # neighbourhoods make cov near-singular along the normal, so each step
    # amplifies it by ~lambda_2 / eps whatever the in-plane anisotropy.
    # M^-1 v is adj(M) v / det(M) with det(M) > 0, and the division is
    # absorbed by the normalisation
    tr = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    eps = (1e-6 * tr + 1e-12)[..., None, None]
    adj = _adjugate_sym(cov + eps * torch.eye(3, dtype=torch.float64,
                                              device=cov.device))
    v = torch.full((b, n, 3), 0.577350269, dtype=torch.float64,
                   device=cov.device)
    for _ in range(4):
        v = torch.einsum("bnij,bnj->bni", adj, v)
        v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                         keepdim=True), 1e-20)
    return v.to(torch.float32)


def _estimate_yaw_translation_p2plane(p, q, nrm, w):
    """Damped Gauss-Newton increment minimising
    sum w ((Rz(theta)(p - pbar) + pbar + t - q) . n)^2, linearised in
    theta, per pair; (B, n, 3) x3 and (B, n) -> R (B,3,3), t (B,3), the
    exact world-frame increment of the clipped step."""
    wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:, None]
    p_bar = torch.sum(w[..., None] * p, dim=1) / wsum
    pt = p - p_bar[:, None, :]
    r = torch.sum((p - q) * nrm, dim=-1)                        # (B, n)
    a = -pt[..., 1] * nrm[..., 0] + pt[..., 0] * nrm[..., 1]    # dr/dtheta
    A = torch.stack([a, nrm[..., 0], nrm[..., 1], nrm[..., 2]], dim=-1)
    Aw = A * w[..., None]
    # Levenberg-style damping relative to the system's scale: one panel's
    # correspondences leave some directions near-unobservable
    H = Aw.mT @ A
    tr_h = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    H = H + (1e-6 * tr_h + 1e-9)[:, None, None] * torch.eye(
        4, dtype=H.dtype, device=H.device)
    g = torch.einsum("bni,bn->bi", Aw, r)
    x = torch.linalg.solve(H, -g)
    # trust region per iteration: near a basin the increments are small
    theta = torch.clamp(x[:, 0], -0.3, 0.3)
    t_lin = x[:, 1:]
    t_norm = torch.linalg.vector_norm(t_lin, dim=-1, keepdim=True)
    t_lin = t_lin * (torch.clamp_max(t_norm, 1.0)
                     / torch.clamp_min(t_norm, 1e-20))
    R = _rot_z(theta)
    # the rotation was taken about p_bar: fold it into a world-frame move
    t = p_bar - torch.einsum("bij,bj->bi", R, p_bar) + t_lin
    return R, t


def icp_p2plane_batch(src, src_mask, dst, dst_mask, init_transforms,
                      radius: float = 0.2, its: int = 30, knn: int = 16,
                      dst_normals=None, *, device: torch.device | str):
    """Batched ground-plane-constrained point-to-plane ICP on ``device``,
    with the contract of ``icp_p2point_batch`` (no unconstrained variant:
    every reference call site sets with_constraint=True).

    ``dst_normals``: optional (B, N, 3) normals of ``dst``; estimated from
    ``knn`` neighbours otherwise. Returns numpy (transforms (B,4,4)
    float64, fitness (B,), inlier_rmse (B,))."""
    if dst_normals is None:
        dst_normals = estimate_normals_batch(dst, dst_mask, k=knn,
                                             device=device)
    if not torch.is_tensor(dst_normals):
        dst_normals = torch.from_numpy(np.array(dst_normals, np.float32))
    nrm64 = dst_normals.to(device=device, dtype=torch.float64)

    def estimate(moved, idx, w, dst64):
        return _estimate_yaw_translation_p2plane(
            moved, gather_points(dst64, idx), gather_points(nrm64, idx), w)

    return run_icp(src, src_mask, dst, dst_mask, init_transforms, radius, its,
                   estimate, device=device)
