"""Plain reference of an alignment request: resample, forward, decode,
flip resolution and constrained point-to-point ICP.

The resample and the ICP subsample are replayed from the request seed by
the rule of the serving API (one ``numpy`` generator; per forward chunk of
``batch_size`` pairs one ``random((m, n))`` draw for the first clouds and
one for the second; index ``floor(u * count)``; then, with ICP, one
``choice(count, n_max, replace=False)`` for every cloud longer than
``n_max = min(4096, longest cloud of the request)``, first clouds then
second). Every call of the run is replayed in order, the warm-up's too, so
that a sampled request sees the generator's state it saw in the program.

Poses are float64 numpy; the network runs in float32 on the device
(``model.Model``). ICP keeps the pose algebra in float64 and the
nearest-neighbour search in float32 (``model.sq_distances``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model import Model, sq_distances

ICP_MAX_POINTS = 4096
NN_BLOCK = 1 << 28  # distances a block of source rows (1 GiB in float32)


class Replay:
    """The serving API's generator, replayed call by call."""

    def __init__(self, seed: int, num_points: int, batch_size: int):
        self.rng = np.random.default_rng(seed)
        self.n = num_points
        self.batch_size = batch_size

    def _resample(self, clouds):
        lens = np.asarray([len(c) for c in clouds], np.int64)
        u = self.rng.random((len(clouds), self.n))
        idx = np.minimum((u * lens[:, None]).astype(np.int64),
                         lens[:, None] - 1)
        return np.stack([c[i] for c, i in zip(clouds, idx)]).astype(np.float32)

    def _pad(self, clouds, n_max):
        arr = np.zeros((len(clouds), n_max, 3), np.float32)
        msk = np.zeros((len(clouds), n_max), bool)
        for i, pc in enumerate(clouds):
            if len(pc) > n_max:
                pc = pc[self.rng.choice(len(pc), n_max, replace=False)]
            arr[i, :len(pc)] = pc
            msk[i, :len(pc)] = True
        return arr, msk

    def call(self, pcs1, pcs2, refine_icp: bool):
        """The inputs the call's forward chunks and ICP saw: resampled
        (n, N, 3) first and second clouds, and with ICP the padded
        (src, src_mask, dst, dst_mask)."""
        a, b = [], []
        for s in range(0, len(pcs1), self.batch_size):
            a.append(self._resample(pcs1[s:s + self.batch_size]))
            b.append(self._resample(pcs2[s:s + self.batch_size]))
        out = {"a": np.concatenate(a), "b": np.concatenate(b)}
        if refine_icp:
            n_max = min(max(len(p) for p in (*pcs1, *pcs2)), ICP_MAX_POINTS)
            out["src"], out["src_mask"] = self._pad(pcs1, n_max)
            out["dst"], out["dst_mask"] = self._pad(pcs2, n_max)
        return out


def _class_angles(logits, bins, residual_scale):
    """Eval decode (tp8.py:241-244): argmax bin + raw residual * scale,
    minus 2 pi above pi; and the margin of the argmax over the next bin."""
    cls_logits = logits[:, :bins]
    cls = np.argmax(cls_logits, axis=1)
    res = np.take_along_axis(logits[:, bins:], cls[:, None], 1)[:, 0]
    angle = cls * (2 * np.pi / bins) + res.astype(np.float64) * residual_scale
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    top2 = np.sort(cls_logits, axis=1)[:, -2:]
    return angle, top2[:, 1] - top2[:, 0]


def rigid(points, t, angle, centre):
    """R(angle) (p - c) + c + t for (B, n, 3) float32 tensors."""
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    p = points - centre[:, None]
    x, y = p[..., 0], p[..., 1]
    moved = torch.stack([c * x - s * y, s * x + c * y, p[..., 2]], -1)
    return moved + (centre + t)[:, None]


def nearest(src, dst, dst_mask):
    """(idx, d2) of each src point's nearest valid dst point (the first on
    ties), float32."""
    idx, d2 = [], []
    rows = max(1, NN_BLOCK // (src.shape[0] * dst.shape[1]))
    for s in range(0, src.shape[1], rows):
        d = sq_distances(src[:, s:s + rows], dst)
        d = torch.where(dst_mask[:, None, :], d, torch.inf)
        i = torch.argmin(d, dim=-1)
        idx.append(i)
        d2.append(torch.gather(d, -1, i[..., None])[..., 0])
    return torch.cat(idx, 1), torch.cat(d2, 1)


def forward_decode(model: Model, a, b, residual_scale, resolve_flips, device):
    """Network answers of a request's resampled pairs: translations,
    angles (float64), centres and each pair's smallest decision margin
    (argmax logit margins; with flips also the relative chamfer gap)."""
    with torch.no_grad():
        pa = torch.as_tensor(a, device=device)
        pb = torch.as_tensor(b, device=device)
        out = model.forward(pa, pb)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        bins = model.bins
        ang1, m1 = _class_angles(host["pred_pc1angle_logits"], bins,
                                 residual_scale)
        ang2, m2 = _class_angles(host["pred_pc2angle_logits"], bins,
                                 residual_scale)
        angr, m3 = _class_angles(host["pred_remaining_angle_logits"], bins,
                                 residual_scale)
        angles = ang2 - ang1 + angr
        t = host["pred_translations"].astype(np.float64)
        c = host["pred_s2_pc1centers"].astype(np.float64)
        margins = {"logit": np.minimum(np.minimum(m1, m2), m3)}
        if resolve_flips:
            tt = torch.as_tensor(t, dtype=torch.float32, device=device)
            cc = torch.as_tensor(c, dtype=torch.float32, device=device)
            aa = torch.as_tensor(angles, dtype=torch.float32, device=device)
            full = torch.ones(pb.shape[:2], dtype=torch.bool, device=device)
            d = [torch.sqrt(nearest(rigid(pa, tt, x, cc), pb, full)[1]).mean(1)
                 for x in (aa, aa + np.pi)]
            d0, d1 = d[0].cpu().numpy(), d[1].cpu().numpy()
            angles = np.where(d1 < d0, angles + np.pi, angles)
            angles = (angles + np.pi) % (2 * np.pi) - np.pi
            margins["flip"] = np.abs(d1 - d0) / np.maximum(np.maximum(d0, d1),
                                                           1e-12)
    return t, angles, c, margins


def mat_angle(t, a, c):
    """(n, 4, 4) float64 ``T(c + t) Rz(a) T(-c)``."""
    n = len(a)
    m = np.tile(np.eye(4), (n, 1, 1))
    ca, sa = np.cos(a), np.sin(a)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = ca, -sa, sa, ca
    rc = np.einsum("nij,nj->ni", m[:, :3, :3], c)
    m[:, :3, 3] = c - rc + t
    return m


def icp(src, src_mask, dst, dst_mask, init, radius, its, device):
    """Constrained (yaw + translation) point-to-point ICP, float64 pose
    algebra: ``its`` iterations of nearest valid neighbour, radius gate,
    weighted closed-form update. Returns (B, 4, 4) float64."""
    with torch.no_grad():
        f64 = torch.float64
        s64 = torch.as_tensor(src, device=device).to(f64)
        d32 = torch.as_tensor(dst, device=device)
        d64 = d32.to(f64)
        sm = torch.as_tensor(src_mask, device=device)
        dm = torch.as_tensor(dst_mask, device=device)
        R = torch.as_tensor(init[:, :3, :3], device=device)
        t = torch.as_tensor(init[:, :3, 3], device=device)
        r2 = float(np.float32(radius) * np.float32(radius))
        for _ in range(its):
            moved = (s64[:, :, None, :] * R[:, None]).sum(-1) + t[:, None]
            idx, d2 = nearest(moved.to(torch.float32), d32, dm)
            w = (sm & (d2 < r2)).to(f64)
            q = torch.gather(d64, 1, idx[..., None].expand(-1, -1, 3))
            wsum = w.sum(1).clamp_min(1e-12)[:, None]
            pbar = (w[..., None] * moved).sum(1) / wsum
            qbar = (w[..., None] * q).sum(1) / wsum
            pa, qb = moved - pbar[:, None], q - qbar[:, None]
            num = (w * (pa[..., 0] * qb[..., 1]
                        - pa[..., 1] * qb[..., 0])).sum(1)
            den = (w * (pa[..., 0] * qb[..., 0]
                        + pa[..., 1] * qb[..., 1])).sum(1)
            yaw = torch.atan2(num, den)
            c, s = torch.cos(yaw), torch.sin(yaw)
            Ri = torch.zeros_like(R)
            Ri[:, 0, 0], Ri[:, 0, 1], Ri[:, 1, 0], Ri[:, 1, 1] = c, -s, s, c
            Ri[:, 2, 2] = 1.0
            ti = qbar - (Ri * pbar[:, None, :]).sum(-1)
            has = w.sum(1) > 0
            Ri = torch.where(has[:, None, None], Ri, torch.eye(3, dtype=f64,
                                                               device=device))
            ti = torch.where(has[:, None], ti, torch.zeros_like(ti))
            R = Ri @ R
            t = (Ri * t[:, None, :]).sum(-1) + ti
        out = np.tile(np.eye(4), (len(init), 1, 1))
        out[:, :3, :3] = R.cpu().numpy()
        out[:, :3, 3] = t.cpu().numpy()
    return out
