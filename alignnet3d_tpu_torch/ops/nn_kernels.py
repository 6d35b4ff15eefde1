"""Batched brute-force nearest-neighbour argmin.

Counterpart of ``alignnet3d_tpu/ops/nn_kernels.py`` and of the XLA path of
``alignnet3d_tpu/icp/p2point.py:_nn_correspondences``. For each source
point: the index and squared distance of the nearest valid destination
point, with

    d2 = max((|a|^2 - 2 a.q) + |q|^2, 0),  +inf where q is masked,

and the lowest index on ties; a NaN distance (from a NaN or infinite
coordinate, masked columns included) wins, as ``torch.argmin`` takes the
first NaN. On non-finite input the reference is the XLA path, whose
``jnp.argmin`` does the same, not the Pallas kernel: its strict-less
minimum over column tiles never takes a NaN distance. The batch axis is
native (the JAX callers vmap over it). The
CUDA kernel (``csrc/nn_argmin.cu``) and ``nn_argmin_plain`` evaluate every
product and sum in the same order with separate roundings, so on the card
they agree bit for bit, non-finite inputs included. The kernel's pre-pass
builds a column table whose plain version is ``column_table_plain``.
"""

from __future__ import annotations

import torch

from alignnet3d_tpu_torch.ops._batch import batch_chunks

GROUP = 8     # the kernel's column group (csrc/nn_argmin.cu: kGroup)
# columns a sweep block visits at most; their answers are merged. Fastest of
# 64-4096 at both the flip and the ICP shape on an H100 (PERF.md)
CHUNK = 512

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
    if b < 1 or n1 < 1 or dst.shape[1] < 1:
        raise ValueError(f"nn_argmin: unsupported shapes {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()
            and dst_mask.is_contiguous()):
        raise ValueError("nn_argmin: inputs must be contiguous")


def column_table_plain(dst: torch.Tensor, dst_mask: torch.Tensor):
    """The kernel's per-pair column table and column counts, in tensor ops.

    Returns table (B, n2p, 4) float32, one row (-2x, -2y, -2z, |q|^2 or
    +inf where masked) per destination point and (0, 0, 0, +inf) for the
    padding up to n2p, a multiple of GROUP; and cols (B,) int32, the columns
    a sweep must visit: 1 + the last valid index, 0 for a pair with none.
    The values are the plain version's ``-2 dst`` and masked ``|q|^2``, bit
    for bit.
    """
    n2 = dst.shape[1]
    pad = -n2 % GROUP
    if pad:
        dst = torch.nn.functional.pad(dst, (0, 0, 0, pad))
        dst_mask = torch.nn.functional.pad(dst_mask, (0, pad))
    sb = torch.where(dst_mask, _sq_norm(dst),
                     torch.full_like(dst[..., 0], float("inf")))
    table = torch.cat([-2.0 * dst, sb[..., None]], dim=-1)
    pos = torch.arange(1, n2 + pad + 1, dtype=torch.int32, device=dst.device)
    cols = torch.where(dst_mask, pos, 0).amax(dim=1)
    return table, cols


def column_table(dst: torch.Tensor, dst_mask: torch.Tensor):
    """``column_table_plain`` for CPU tensors; for CUDA tensors the
    kernel's own pre-pass, which nn_argmin runs before every sweep."""
    if dst.device.type == "cpu":
        return column_table_plain(dst, dst_mask)
    _check(dst, dst, dst_mask)
    lib = _library()
    b, n2, _ = dst.shape
    n2p = -(-n2 // GROUP) * GROUP
    table = torch.empty((b, n2p, 4), dtype=torch.float32, device=dst.device)
    cols = torch.empty((b,), dtype=torch.int32, device=dst.device)
    with torch.cuda.device(dst.device):
        for s, e in batch_chunks(b):
            # the kernel also writes each pair's non-finite flag after the
            # counts
            counts = torch.empty((2, e - s), dtype=torch.int32,
                                 device=dst.device)
            rc = lib.nn_table_launch(
                dst[s:e].data_ptr(), dst_mask[s:e].data_ptr(), e - s, n2, n2p,
                table[s:e].data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream(dst.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    f"nn_argmin: table launch failed, CUDA error {rc}")
            cols[s:e] = counts[0]
    return table, cols


def _library():
    from alignnet3d_tpu_torch.ops._build import load_library

    return load_library()


def launch(src, dst, dst_mask, chunk: int):
    """The kernel with ``chunk`` columns a sweep block (CHUNK in
    ``nn_argmin``): pre-pass, sweep and, for more than one chunk, merge.
    Returns idx (B, n1) int64, d2 (B, n1) float32."""
    _check(src, dst, dst_mask)
    lib = _library()
    b, n1, _ = src.shape
    n2 = dst.shape[1]
    n2p = -(-n2 // GROUP) * GROUP
    splits = -(-n2p // chunk)
    idx = torch.empty((b, n1), dtype=torch.int64, device=src.device)
    d2 = torch.empty((b, n1), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        for s, e in batch_chunks(b):
            m = e - s
            # one scratch buffer, in 4-byte words: the column table (16-byte
            # rows first, so aligned), the column counts and non-finite
            # flags, and the chunks' answers
            n_table, n_cols = m * n2p * 4, -(-2 * m // 4) * 4
            n_part = m * splits * n1 if splits > 1 else 0
            scratch = torch.empty(n_table + n_cols + 2 * n_part,
                                  dtype=torch.float32, device=src.device)
            table = scratch.data_ptr()
            cols = table + 4 * n_table
            part_d2 = cols + 4 * n_cols if n_part else None
            part_idx = part_d2 + 4 * n_part if n_part else None
            rc = lib.nn_argmin_launch(
                src[s:e].data_ptr(), dst[s:e].data_ptr(),
                dst_mask[s:e].data_ptr(), m, n1, n2, n2p, chunk, table, cols,
                part_d2, part_idx, idx[s:e].data_ptr(), d2[s:e].data_ptr(),
                torch.cuda.current_stream(src.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    f"nn_argmin: kernel launch failed, CUDA error {rc}")
    return idx, d2


def nn_argmin(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor):
    """Nearest valid neighbour: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns idx (B, n1) int64, d2 (B, n1) f32."""
    if src.device.type == "cpu":
        return nn_argmin_plain(src, dst, dst_mask)
    out = launch(src, dst, dst_mask, CHUNK)
    nn_argmin.launches += 1
    return out


nn_argmin.launches = 0
