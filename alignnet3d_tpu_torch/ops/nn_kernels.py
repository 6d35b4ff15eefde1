"""Batched brute-force nearest-neighbour argmin.

Counterpart of ``alignnet3d_tpu/ops/nn_kernels.py`` and of the XLA path of
``alignnet3d_tpu/icp/p2point.py:_nn_correspondences``. For each source
point: the index and squared distance of the nearest valid destination
point, with

    d2 = max((|a|^2 - 2 a.q) + |q|^2, 0),  +inf where q is masked,

and the lowest index on ties. The batch axis is native (the JAX callers
vmap over it). The CUDA kernel (``csrc/nn_argmin.cu``) and
``nn_argmin_plain`` evaluate every product and sum in the same order with
separate roundings, so on the card they agree bit for bit.
"""

from __future__ import annotations

import torch

# elements of one (B, chunk, n2) distance block: about a megabyte keeps the
# CPU's passes in cache; on the card a larger block means fewer launches
_CHUNK_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 28}


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def nn_argmin_plain(src: torch.Tensor, dst: torch.Tensor,
                    dst_mask: torch.Tensor):
    """src (B, n1, 3), dst (B, n2, 3), dst_mask (B, n2) bool ->
    idx (B, n1) int64, d2 (B, n1) float32.

    The cross term is summed as ((a0 q0' + a1 q1') + a2 q2') with
    q' = -2 q, which equals -2 (a.q) exactly; every step rounds on its own.
    """
    bsz, n1, _ = src.shape
    n2 = dst.shape[1]
    sa = _sq_norm(src)
    sb = torch.where(dst_mask, _sq_norm(dst),
                     torch.full_like(dst[..., 0], float("inf")))
    qm = (-2.0 * dst).permute(0, 2, 1).contiguous()  # (B, 3, n2)
    q0, q1, q2 = qm[:, 0, None, :], qm[:, 1, None, :], qm[:, 2, None, :]
    chunk = max(1, _CHUNK_ELEMS.get(src.device.type, 1 << 20) // max(1, bsz * n2))
    idx_parts, d2_parts = [], []
    for s in range(0, n1, chunk):
        a = src[:, s:s + chunk]
        d2 = a[..., 0, None] * q0          # in place from here on
        tmp = torch.mul(a[..., 1, None], q1)
        d2 += tmp
        torch.mul(a[..., 2, None], q2, out=tmp)
        d2 += tmp
        d2 += sa[:, s:s + chunk, None]
        d2 += sb[:, None, :]
        d2.clamp_(min=0.0)
        idx = torch.argmin(d2, dim=-1)  # first index on ties
        idx_parts.append(idx)
        d2_parts.append(torch.gather(d2, -1, idx[..., None])[..., 0])
    return torch.cat(idx_parts, dim=1), torch.cat(d2_parts, dim=1)


def _check(src, dst, dst_mask):
    if src.device.type != "cuda":
        raise ValueError(f"nn_argmin: unsupported device {src.device}")
    if dst.device != src.device or dst_mask.device != src.device:
        raise ValueError("nn_argmin: all inputs must be on one device")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise ValueError("nn_argmin: points must be float32")
    if dst_mask.dtype != torch.bool:
        raise ValueError("nn_argmin: dst_mask must be bool")
    if src.dim() != 3 or src.shape[-1] != 3 or dst.dim() != 3 or dst.shape[-1] != 3:
        raise ValueError("nn_argmin: points must be (B, n, 3)")
    b, n1, _ = src.shape
    if dst.shape[0] != b or tuple(dst_mask.shape) != tuple(dst.shape[:2]):
        raise ValueError("nn_argmin: batch or mask shape mismatch")
    if not 1 <= b <= 65535 or n1 < 1 or dst.shape[1] < 1:
        raise ValueError(f"nn_argmin: unsupported shapes {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()
            and dst_mask.is_contiguous()):
        raise ValueError("nn_argmin: inputs must be contiguous")


def nn_argmin(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor):
    """Nearest valid neighbour: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns idx (B, n1) int64, d2 (B, n1) f32."""
    if src.device.type == "cpu":
        return nn_argmin_plain(src, dst, dst_mask)
    _check(src, dst, dst_mask)
    from alignnet3d_tpu_torch.ops._build import load_library

    lib = load_library()
    b, n1, _ = src.shape
    idx = torch.empty((b, n1), dtype=torch.int64, device=src.device)
    d2 = torch.empty((b, n1), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.nn_argmin_launch(
            src.data_ptr(), dst.data_ptr(), dst_mask.data_ptr(), b, n1,
            dst.shape[1], idx.data_ptr(), d2.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nn_argmin: kernel launch failed, CUDA error {rc}")
    nn_argmin.launches += 1
    return idx, d2


nn_argmin.launches = 0
