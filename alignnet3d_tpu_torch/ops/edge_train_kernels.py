"""Fused DGCNN edge stage for TRAINING: batch-statistic BN, forward and
backward, without (B, N, k, C) tensors in device memory.

Counterpart of ``alignnet3d_tpu/ops/edge_train_kernels.py``
(``fused_edge_stage_train``). With ``w1 = [P; Q]``, U = f (P - Q) + b1 and
V = f Q (``edge_conv_kernels._split``), over the edges (i, t),
j = idx[i, t]:

    h1 = relu(BN1(U_i + V_j)),  h2 = relu(BN2(h1 W2 + b2)),  out_i = max_t h2,

each BN normalising with the exact biased statistics of the current batch
(E[x^2] - E[x]^2, eps 1e-3). It returns ``(out, (mu1, var1, mu2, var2))``;
the statistics carry no gradient (the caller's EMA update reads them).
The max over k gives its whole cotangent to the FIRST t attaining it.

For a CUDA tensor, ``fused_edge_stage_train`` runs the passes of
``csrc/edge_train.cu`` inside one ``torch.autograd.Function``, 10 launches
a call (stats1, fwd and select with two reduces forward; bwd2, bwd_mid and
bwd_in with two reduces backward), of which four product passes (fwd, and
pre2/dh1/dW2 in bwd_mid). U, V and the chain back through them (df, dW1,
db1), and the step from the BN sums to (mu, var) and to the BN gradients,
stay in ``torch.matmul``/``einsum`` and a few (C,)-vector operations, as
the JAX wrapper leaves them to XLA. ``fused_edge_stage_train_plain`` is the
unfused graph in plain PyTorch, differentiated by autograd; it serves CPU
tensors and is the kernel's reference on the card. ``select_plain`` is the
plain version of the kernel's pick of the max over k (fwd, select). Any
batch runs in one launch a pass. Everything runs in float32, and a NaN
propagates as in the twin.

With several processes (``parallel/multihost.py``) both BNs take the
statistics of the global batch, as under the JAX package's data-parallel
mesh: forward, the stats1 and fwd sums are all-reduced before they become
(mu, var), with the count taken over the global batch; backward, the bwd2
sums and the (sa1, sb1) part of bwd_mid's are all-reduced before they
become the means of the BN gradient. The gradients of the parameters
(dW2, db2, and the sums that are dg and dbeta) stay this process's own:
``DistributedDataParallel`` reduces them. The collectives sit between the
launches; the CUDA sources know nothing of them. The plain version takes
the same statistics through ``batchnorm.batch_moments``.

dV is scattered with atomics, so on the card df and dW1 may differ between
two runs at rounding level; every other output is bit-reproducible. The
backward keeps dy1 = dL/dy1 of every edge, (B N k, C1) float32, from
bwd_mid to bwd_in: 671 MB at 256 clouds x 512 points, k=20, C1=64.
"""

from __future__ import annotations

import torch

from alignnet3d_tpu_torch.models.batchnorm import batch_moments
from alignnet3d_tpu_torch.ops.edge_conv_kernels import _split
from alignnet3d_tpu_torch.parallel import multihost
from alignnet3d_tpu_torch.ops.stable_max import stable_max

EPS = 1e-3

# kernel tiling, as in csrc/edge_train.cu
_GROUP, _EDGES, _LANES = 4, 10, 64
_TILE_A, _TILE_B = 4, 8
_MAX_SMEM = 232448  # bytes a block may use on sm_90
_PPB_FWD, _PPB_MID = 32, 128  # points per block of the product passes
_ROWS_STATS1, _ROWS_BWD2 = 512, 128  # edge / point rows per block


def _batch_norm_train(x, g, be, eps):
    """Biased batch statistics over all axes but the last, as
    ``EmaBatchNorm`` takes them in train mode: (y, mean, var)."""
    mean, var = batch_moments(x)
    return (x - mean) * torch.rsqrt(var + eps) * g + be, mean, var


def fused_edge_stage_train_plain(f, idx, w1, b1, g1, be1, w2, b2, g2, be2,
                                 eps: float = EPS):
    """The unfused graph: gather, BN1, relu, W2, BN2, relu, ``stable_max``
    over k. f (B, N, C), idx (B, N, k) int, w1 (2C, C1), w2 (C1, C2).
    Returns (out (B, N, C2), (mu1, var1, mu2, var2) detached)."""
    u, v = _split(f, w1, b1)
    bsz, n, c1 = u.shape
    k = idx.shape[-1]
    offsets = (torch.arange(bsz, device=idx.device) * n)[:, None, None]
    rows = (idx.to(torch.int64) + offsets).reshape(-1)
    vj = v.reshape(bsz * n, c1).index_select(0, rows).reshape(bsz, n, k, c1)
    y1, mu1, var1 = _batch_norm_train(u[:, :, None, :] + vj, g1, be1, eps)
    pre2 = torch.matmul(torch.relu(y1), w2) + b2
    y2, mu2, var2 = _batch_norm_train(pre2, g2, be2, eps)
    out = stable_max(torch.relu(y2), 2)
    return out, tuple(s.detach() for s in (mu1, var1, mu2, var2))


def select_plain(pre2, g2, be2, mu2, var2, eps: float = EPS):
    """The kernel's pick of the max over k, in plain PyTorch. relu(BN2(.))
    is monotone in pre2 per channel (r2 > 0), so the first t attaining the
    max of h2 is the first argmax of pre2 where g2 > 0, the first argmin
    where g2 < 0 and t = 0 where g2 == 0. A NaN or an infinity in pre2 makes
    its channel's var2 NaN, so out is NaN there whatever the pick.
    pre2 (B, N, k, C2). Returns (out, slot, xhat2),
    each (B, N, C2): relu(g2 xhat2 + be2) at the pick, its t (int64) and
    xhat2 = (pre2 - mu2) rsqrt(var2 + eps) there."""
    slot = torch.argmax(pre2 * torch.sign(g2), dim=2, keepdim=True)
    xhat2 = (torch.gather(pre2, 2, slot).squeeze(2) - mu2) * torch.rsqrt(
        var2 + eps)
    return torch.relu(xhat2 * g2 + be2), slot.squeeze(2), xhat2


def _padded(c: int, m: int) -> int:
    return (c + m - 1) // m * m


def _smem_bytes(k: int, c1: int, c2: int) -> int:
    """Shared memory of the largest block (bwd_mid): W2 with padded rows,
    the h1/xhat1/dpre2 rows of a staged group, and the float64 dW2 tiles
    and per-team sums."""
    c1p, c2p = _padded(c1, 4), _padded(c2, _TILE_B)
    rows = _GROUP * k + _EDGES
    return (4 * (c1p * (c2p + 1) + 2 * rows * c1p + rows * c2p)
            + 8 * (_GROUP * _LANES * _TILE_A * _TILE_B
                   + _GROUP * (c2 + 2 * c1)))


def _check(f, idx, w1, b1, g1, be1, w2, b2, g2, be2):
    params = (w1, b1, g1, be1, w2, b2, g2, be2)
    if any(t.dtype != torch.float32 for t in (f, *params)):
        raise ValueError("fused_edge_stage_train: f and weights must be "
                         "float32")
    if idx.dtype != torch.int64:
        raise ValueError("fused_edge_stage_train: idx must be int64")
    if f.dim() != 3 or idx.dim() != 3:
        raise ValueError("fused_edge_stage_train: f (B, N, C), idx (B, N, k)")
    b, n, c = f.shape
    k = idx.shape[-1]
    if tuple(idx.shape[:2]) != (b, n) or not 1 <= k <= n:
        raise ValueError(f"fused_edge_stage_train: idx {tuple(idx.shape)} "
                         f"does not fit f {tuple(f.shape)}")
    c1, c2 = w1.shape[-1], w2.shape[-1]
    if (w1.dim() != 2 or w1.shape[0] != 2 * c or w2.dim() != 2
            or w2.shape[0] != c1
            or any(tuple(t.shape) != (c1,) for t in (b1, g1, be1))
            or any(tuple(t.shape) != (c2,) for t in (b2, g2, be2))):
        raise ValueError("fused_edge_stage_train: weight shapes do not chain")
    if (_padded(c1, 4) // _TILE_A) * (_padded(c2, _TILE_B) // _TILE_B) \
            > _GROUP * _LANES:
        raise ValueError("fused_edge_stage_train: C1 x C2 exceeds the dW2 "
                         "tiles of one block (C1 * C2 <= 8192)")
    if _smem_bytes(k, c1, c2) > _MAX_SMEM:
        raise ValueError("fused_edge_stage_train: W2 and the edge rows "
                         "exceed a block's shared memory")
    if f.device.type != "cuda":
        raise ValueError(
            f"fused_edge_stage_train: unsupported device {f.device}")
    if any(t.device != f.device for t in (idx, *params)):
        raise ValueError("fused_edge_stage_train: all inputs must be on one "
                         "device")


def _launch(name: str, *args) -> None:
    """Call one launcher of csrc/edge_train.cu on the current stream and
    count the launch."""
    from alignnet3d_tpu_torch.ops._build import load_library

    device = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(load_library(), f"edge_train_{name}_launch")(*ptrs,
                                                                   stream)
    if rc != 0:
        raise RuntimeError(f"fused_edge_stage_train: {name} launch failed, "
                           f"CUDA error {rc}")
    fused_edge_stage_train.launches += 1


def _sums(name: str, rows: int, cols: int, *args) -> torch.Tensor:
    """Run a pass that writes (rows, cols) float64 per-block partials, then
    the fixed-order reduce: returns the (cols,) sums as float32."""
    device = args[0].device
    part = torch.empty((rows, cols), dtype=torch.float64, device=device)
    _launch(name, *args, part)
    total = torch.empty((cols,), dtype=torch.float32, device=device)
    _launch("reduce", part, rows, cols, total)
    return total


def _bn_table(s, ss, count, g, be, eps):
    """(mu, var) from the sums and the (4, C) table mu, r, gamma, beta."""
    mu = s / count
    var = ss / count - mu * mu
    return mu, var, torch.stack([mu, torch.rsqrt(var + eps), g, be])


class _FusedEdgeStageTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, idx, w1, b1, g1, be1, w2, b2, g2, be2, eps):
        f, w1, w2 = f.contiguous(), w1.contiguous(), w2.contiguous()
        idx = idx.contiguous()
        u, v = (t.contiguous() for t in _split(f, w1, b1))
        b, n, c1 = u.shape
        k, c2 = idx.shape[-1], w2.shape[1]
        edges = b * n * k
        # the BN statistics' sample count: the global batch's edges
        count = edges * multihost.process_count()
        s1 = multihost.all_reduce_(_sums(
            "stats1", -(-edges // _ROWS_STATS1), 2 * c1,
            u, v, idx, b, n, k, c1, _ROWS_STATS1))
        mu1, var1, bn1 = _bn_table(s1[:c1], s1[c1:], count, g1, be1, eps)
        # the pick's t and pre2 (xs), then out and xhat2 at the pick
        slot = torch.empty((b, n, c2), dtype=torch.int32, device=f.device)
        xs = torch.empty((b, n, c2), dtype=torch.float32, device=f.device)
        s2 = multihost.all_reduce_(_sums(
            "fwd", b * -(-n // _PPB_FWD), 2 * c2,
            u, v, idx, bn1, w2, b2, g2.contiguous(), b, n, k, c1, c2,
            _PPB_FWD, slot, xs))
        mu2, var2, bn2 = _bn_table(s2[:c2], s2[c2:], count, g2, be2, eps)
        out = torch.empty_like(xs)
        _launch("select", bn2, b, n, c2, xs, out)
        ctx.save_for_backward(f, idx, w1, w2, b2, u, v, bn1, bn2, out, slot,
                              xs)
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        return out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, dout, *_):
        f, idx, w1, w2, b2, u, v, bn1, bn2, out, slot, xs = ctx.saved_tensors
        dout = dout.contiguous()
        b, n, c = f.shape
        c1, c2, k = u.shape[-1], w2.shape[1], idx.shape[-1]
        edges = b * n * k
        count = edges * multihost.process_count()
        s = _sums("bwd2", -(-(b * n) // _ROWS_BWD2), 2 * c2,
                  dout, out, xs, b, n, c2, _ROWS_BWD2)
        sa2, sb2 = s[:c2], s[c2:]  # this process's dbe2, dg2
        m2 = multihost.all_reduce_(torch.stack([sa2, sb2])) / count
        cols = c1 * c2 + c2 + 2 * c1
        dy1 = torch.empty((edges, c1), dtype=torch.float32, device=f.device)
        s = _sums("bwd_mid", b * -(-n // _PPB_MID), cols,
                  u, v, idx, bn1, w2, b2, bn2, slot, dout, out, m2,
                  b, n, k, c1, c2, _PPB_MID, dy1)
        dw2 = s[:c1 * c2].reshape(c1, c2)
        db2 = s[c1 * c2:c1 * c2 + c2]
        sa1, sb1 = s[c1 * c2 + c2:c1 * c2 + c2 + c1], s[c1 * c2 + c2 + c1:]
        m1 = multihost.all_reduce_(torch.stack([sa1, sb1])) / count
        du = torch.empty_like(u)
        dv = torch.zeros_like(v)
        _launch("bwd_in", u, v, idx, bn1, m1.contiguous(), dy1, b, n, k, c1,
                du, dv)
        del dy1  # back to the allocator before the chain below
        # chain through U = f (P - Q) + b1 and V = f Q
        a_w, q_w = w1[:c] - w1[c:], w1[c:]
        df = torch.matmul(du, a_w.T) + torch.matmul(dv, q_w.T)
        da = torch.einsum("bnc,bnd->cd", f, du)
        dq = torch.einsum("bnc,bnd->cd", f, dv)
        dw1 = torch.cat([da, dq - da], dim=0)
        db1 = torch.sum(du, dim=(0, 1))
        return (df, None, dw1, db1, sb1, sa1, dw2, db2, sb2, sa2, None)


def fused_edge_stage_train(f, idx, w1, b1, g1, be1, w2, b2, g2, be2,
                           eps: float = EPS):
    """The fused training stage: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors. f (B, N, C) float32, idx (B, N, k)
    int64 in [0, N), w1 (2C, C1), b1/g1/be1 (C1,), w2 (C1, C2),
    b2/g2/be2 (C2,). Returns (out (B, N, C2), (mu1, var1, mu2, var2))."""
    if f.device.type == "cpu":
        return fused_edge_stage_train_plain(f, idx, w1, b1, g1, be1, w2, b2,
                                            g2, be2, eps)
    _check(f, idx, w1, b1, g1, be1, w2, b2, g2, be2)
    out, *stats = _FusedEdgeStageTrain.apply(f, idx, w1, b1, g1, be1, w2,
                                             b2, g2, be2, eps)
    return out, tuple(stats)


fused_edge_stage_train.launches = 0

# the gradients of fused_edge_stage_train, in order; b1 and b2 are absorbed
# by the BN shifts be1 and be2
GRAD_NAMES = ("f", "w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2")
ABSORBED = {"b1": "be1", "b2": "be2"}


def grad_errors(got, ref, names=GRAD_NAMES, absorbed=ABSORBED):
    """Relative L2 error of each gradient in ``got`` against ``ref``, as a
    dict by name. A bias that a BN follows has true gradient 0 (the BN
    absorbs it): both sides hold only f32 cancellation noise there, so its
    error is taken relative to the gradient of the BN's shift
    (``absorbed``: bias name -> shift name), which has the same units."""
    norms = dict(zip(names, (float(r.norm()) for r in ref)))
    return {name: float((g - r).norm())
            / max(norms[absorbed.get(name, name)], 1e-30)
            for name, g, r in zip(names, got, ref)}
