"""Exact k-nearest neighbours from raw points, for the DGCNN graph.

Counterpart of ``alignnet3d_tpu/ops/knn_kernels.py`` (``knn_points_pallas``)
and a drop-in for ``knn(pairwise_distance(points), k)``: for every point,
the indices of its k nearest points of the same cloud, by

    d2 = (|a|^2 - 2 a.q) + |q|^2

in the order of the Pallas kernel's argmin rounds: every NaN distance
first, in index order (``jnp.argmin`` takes the first NaN), then ascending
d2, ties to the lower index; the point itself first among finite points
(up to exact duplicates of it with a lower index). The CUDA kernel
(``csrc/knn_points.cu``) and ``knn_points_plain`` evaluate every product
and sum in the same order with separate roundings, as ``nn_kernels`` does,
and rank by the same key, so on the card they agree bit for bit.

``knn_points`` reaches both through the custom op
``alignnet3d_torch::knn_points`` (CUDA impl: the kernel; CPU impl:
``knn_points_plain``; fake impl: (B, N, k) int64), so ``torch.export`` can
trace the folded DGCNN forward. The launch count is kept in the CUDA impl.
"""

from __future__ import annotations

import torch

from alignnet3d_tpu_torch.ops._batch import batch_chunks
from alignnet3d_tpu_torch.ops.nn_kernels import _sq_norm

MAX_K = 64  # the kernel keeps the k best of each row in registers

# elements of one (B, chunk, N) distance block (see nn_kernels)
_CHUNK_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 26}


def order_key(d2: torch.Tensor) -> torch.Tensor:
    """int64 keys that rank float32 distances as ``knn_points_pallas``
    does: every NaN first (one key, so the stable sort keeps index order),
    then -inf < ... < +inf, with -0.0 and +0.0 equal.

    d2 can be -inf without a NaN: |a_i| = |q_i| = 1.5e19 give squares of
    2.25e38 but a cross term a_i (-2 q_i) = -4.5e38 that overflows, so a
    NaN cannot simply take -inf's place. The kernel's uint32 key
    (``order_key`` in ``csrc/knn_points.cu``) ranks the same way."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return key.masked_fill_(torch.isnan(d2), -(1 << 32))


def knn_points_plain(points: torch.Tensor, k: int) -> torch.Tensor:
    """points (B, N, 3) float32 -> indices (B, N, k) int64.

    The cross term is summed as ((a0 q0' + a1 q1') + a2 q2') with
    q' = -2 q, which equals -2 (a.q) exactly; every step rounds on its own.
    A stable sort on ``order_key`` puts NaN first and equal distances in
    index order."""
    bsz, n, _ = points.shape
    sq = _sq_norm(points)
    qm = (-2.0 * points).permute(0, 2, 1).contiguous()  # (B, 3, N)
    q0, q1, q2 = qm[:, 0, None, :], qm[:, 1, None, :], qm[:, 2, None, :]
    chunk = max(1, _CHUNK_ELEMS.get(points.device.type, 1 << 20)
                // max(1, bsz * n))
    parts = []
    for s in range(0, n, chunk):
        a = points[:, s:s + chunk]
        d2 = a[..., 0, None] * q0          # in place from here on
        tmp = torch.mul(a[..., 1, None], q1)
        d2 += tmp
        torch.mul(a[..., 2, None], q2, out=tmp)
        d2 += tmp
        d2 += sq[:, s:s + chunk, None]
        d2 += sq[:, None, :]
        parts.append(torch.sort(order_key(d2), dim=-1, stable=True)
                     .indices[..., :k])
    return torch.cat(parts, dim=1)


def _check(points, k):
    if points.dtype != torch.float32:
        raise ValueError("knn_points: points must be float32")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError("knn_points: points must be (B, N, 3)")
    if not points.is_contiguous():
        raise ValueError("knn_points: points must be contiguous")
    b, n, _ = points.shape
    if b < 1 or n < 1:
        raise ValueError(f"knn_points: unsupported shape {tuple(points.shape)}")
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"knn_points: k={k} must be in [1, min(N={n}, "
                         f"{MAX_K})]")
    if points.device.type != "cuda":
        raise ValueError(f"knn_points: unsupported device {points.device}")


@torch.library.custom_op("alignnet3d_torch::knn_points", mutates_args=(),
                         device_types="cuda")
def _knn_points_op(points: torch.Tensor, k: int) -> torch.Tensor:
    """The op's CUDA impl: one launch of the kernel per slice of at most
    ``MAX_CLOUDS`` clouds, counted once a call."""
    _check(points, k)
    from alignnet3d_tpu_torch.ops._build import load_library

    lib = load_library()
    b, n, _ = points.shape
    out = torch.empty((b, n, k), dtype=torch.int64, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        for s, e in batch_chunks(b):
            rc = lib.knn_points_launch(points[s:e].data_ptr(), e - s, n, k,
                                       out[s:e].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"knn_points: kernel launch failed, CUDA error {rc}")
    knn_points.launches += 1
    return out


@_knn_points_op.register_kernel("cpu")
def _knn_points_cpu(points, k):
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"knn_points: k={k} must be in [1, N]")
    return knn_points_plain(points, k)


@_knn_points_op.register_fake
def _knn_points_fake(points, k):
    return points.new_empty((*points.shape[:2], k), dtype=torch.int64)


def knn_points(points: torch.Tensor, k: int) -> torch.Tensor:
    """Exact kNN through the op ``alignnet3d_torch::knn_points``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor; any other
    device is refused. Returns (B, N, k) int64."""
    if points.device.type not in ("cpu", "cuda"):
        _check(points, k)  # raises
    return _knn_points_op(points, k)


knn_points.launches = 0
