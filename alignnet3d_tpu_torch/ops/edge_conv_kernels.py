"""Fused DGCNN edge-conv stage over a kNN graph, BN folded.

Counterpart of ``alignnet3d_tpu/ops/edge_conv_kernels.py``
(``fused_edge_stage``). The first edge conv is linear in the edge feature
``[x_i, x_j - x_i]``, so with ``w1 = [P; Q]``

    conv1(edge_ij) = x_i (P - Q) + b1 + x_j Q =: U_i + V_j,

and the stage is

    out_i = max_t relu(relu(U_i + V_{idx[i, t]}) W2 + b2),  (B, N, C2).

U and V are two small products in ``torch.matmul``, as the JAX wrapper
leaves them to XLA. The CUDA kernel (``csrc/edge_stage.cu``) does the rest
with an indexed load of the V rows and the C1 x C2 product on the tensor
cores in 3xTF32 (float32 accuracy), so only the (B, N, C2) result reaches
device memory; ``fused_edge_stage_plain`` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's reference on the card.
Both compute in float32.
"""

from __future__ import annotations

import torch

from alignnet3d_tpu_torch.ops._batch import batch_chunks

C1_MAX = 64  # the kernel's U/V row width: C1 is padded to it
_MAX_SMEM = 232448  # bytes a block may use on sm_90

# elements of one (B, chunk, k, C2) block of the plain version
_CHUNK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 28}


def _split(points, w1, b1, width=None):
    """U = x (P - Q) + b1 and V = x Q, both (B, N, C1) in the weights'
    type (float32 on every path; float64 for a reference); with ``width``,
    (B, N, width) with zero channels past C1 (zero weight columns)."""
    c = points.shape[-1]
    p_w, q_w = w1[:c] - w1[c:], w1[c:]
    if width is not None:
        pad = (0, width - w1.shape[1])
        p_w, q_w = (torch.nn.functional.pad(w, pad) for w in (p_w, q_w))
        b1 = torch.nn.functional.pad(b1, pad)
    x = points.to(w1.dtype)
    return torch.matmul(x, p_w) + b1, torch.matmul(x, q_w)


def fused_edge_stage_plain(points: torch.Tensor, nn_idx: torch.Tensor,
                           w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), nn_idx (B, N, k) int, w1 (2C, C1), b1 (C1,),
    w2 (C1, C2), b2 (C2,) -> (B, N, C2) float32."""
    u, v = _split(points, w1, b1)
    bsz, n, c1 = u.shape
    k = nn_idx.shape[-1]
    flat_v = v.reshape(bsz * n, c1)
    offsets = (torch.arange(bsz, device=nn_idx.device) * n)[:, None, None]
    chunk = max(1, _CHUNK_ELEMS.get(points.device.type, 1 << 22)
                // max(1, bsz * k * w2.shape[1]))
    parts = []
    for s in range(0, n, chunk):
        rows = (nn_idx[:, s:s + chunk].to(torch.int64) + offsets).reshape(-1)
        vj = flat_v.index_select(0, rows).reshape(bsz, -1, k, c1)
        h = torch.clamp_min(u[:, s:s + chunk, None, :] + vj, 0.0)
        h = torch.clamp_min(torch.matmul(h, w2) + b2, 0.0)
        parts.append(torch.amax(h, dim=2))
    return torch.cat(parts, dim=1)


def _smem_bytes(c2: int) -> int:
    """The least shared memory the kernel's block takes: W2 as TF32 (big,
    small) B fragments of C1_MAX rows, and b2, both padded to a multiple
    of 64 columns (a warp's unit). The kernel also stages the cloud's V
    rows when they fit beside them."""
    ntiles = -(-c2 // 64) * 8
    return ntiles * (C1_MAX // 8) * 32 * 16 + ntiles * 8 * 4


def _check(points, nn_idx, w1, b1, w2, b2):
    tensors = (points, nn_idx, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in (points, w1, b1, w2, b2)):
        raise ValueError("fused_edge_stage: points and weights must be float32")
    if nn_idx.dtype != torch.int64:
        raise ValueError("fused_edge_stage: nn_idx must be int64")
    if points.dim() != 3 or nn_idx.dim() != 3:
        raise ValueError("fused_edge_stage: points (B, N, C), nn_idx (B, N, k)")
    b, n, c = points.shape
    k = nn_idx.shape[-1]
    if tuple(nn_idx.shape[:2]) != (b, n) or not 1 <= k <= n:
        raise ValueError(f"fused_edge_stage: nn_idx {tuple(nn_idx.shape)} "
                         f"does not fit points {tuple(points.shape)}")
    if (w1.dim() != 2 or w1.shape[0] != 2 * c or w2.dim() != 2
            or w2.shape[0] != w1.shape[1] or tuple(b1.shape) != (w1.shape[1],)
            or tuple(b2.shape) != (w2.shape[1],)):
        raise ValueError("fused_edge_stage: weight/bias shapes do not chain")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_edge_stage: inputs must be contiguous")
    if w2.shape[0] > C1_MAX:
        raise ValueError(f"fused_edge_stage: C1={w2.shape[0]} exceeds the "
                         f"kernel's {C1_MAX} channels")
    if _smem_bytes(w2.shape[1]) > _MAX_SMEM:
        raise ValueError("fused_edge_stage: W2's fragments exceed a block's "
                         "shared memory")
    if points.device.type != "cuda":
        raise ValueError(f"fused_edge_stage: unsupported device {points.device}")
    if any(t.device != points.device for t in tensors):
        raise ValueError("fused_edge_stage: all inputs must be on one device")


def fused_edge_stage(points: torch.Tensor, nn_idx: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused stage: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``nn_idx`` entries must lie in [0, N). Returns
    (B, N, C2) float32."""
    if points.device.type == "cpu":
        return fused_edge_stage_plain(points, nn_idx, w1, b1, w2, b2)
    _check(points, nn_idx, w1, b1, w2, b2)
    from alignnet3d_tpu_torch.ops._build import load_library

    lib = load_library()
    u, v = (t.contiguous() for t in _split(points, w1, b1, C1_MAX))
    b, n, _ = u.shape
    c1, c2 = w2.shape
    out = torch.empty((b, n, c2), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        for s, e in batch_chunks(b):
            rc = lib.edge_stage_launch(
                u[s:e].data_ptr(), v[s:e].data_ptr(), nn_idx[s:e].data_ptr(),
                w2.data_ptr(), b2.data_ptr(), e - s, n, nn_idx.shape[-1], c1,
                c2, out[s:e].data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"fused_edge_stage: kernel launch failed, CUDA error {rc}")
    fused_edge_stage.launches += 1
    return out


fused_edge_stage.launches = 0
