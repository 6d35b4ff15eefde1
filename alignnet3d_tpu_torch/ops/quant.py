"""Int8 serving math for the folded PointNet chains: the counterpart of
``alignnet3d_tpu/ops/quant.py``, used by ``serving.build_inference_fn(
quantize=...)`` and off by default, as there.

The scheme is dynamic quantisation with no calibration state:
- weights: symmetric per-output-channel int8, the folded BN included
  (quantised once, when the serving function is built);
- activations: per-row dynamic int8. The first layer sees signed
  coordinates and uses symmetric int8 (|max| / 127); every later layer sees
  post-relu rows and uses the unsigned scheme on the signed product, full 8
  bits instead of 7: uq in [0, 255], sq = uq - 128, and
  ``dot(uq, wq) = dot(sq, wq) + 128 * colsum(wq)``;
- the products run in int8 with int32 accumulation (``torch._int_mm``, as
  the JAX package runs XLA's ``dot_general`` with an int32 result; no hand
  kernel there or here), dequantised by (row scale x column scale), then
  bias and relu in float32, then the max over the points in float32.

On the card ``torch._int_mm`` needs a contraction and output width that
are multiples of 8, and cuBLASLt refuses row counts such as 17 or 24 on an
H100 (CUBLAS_STATUS_NOT_SUPPORTED) where multiples of 32 pass, so
``int_mm`` pads the rows to a multiple of 32 and the widths to a multiple
of 8 with zeros (exact: a zero adds nothing to an integer sum).
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_weights_int8(weights):
    """[(Cin, Cout) float32 tensor] -> [(int8 (Cin, Cout), (Cout,) float32
    scale)] on the weights' devices, in numpy as the JAX package rounds."""
    out = []
    for w in weights:
        wn = w.detach().cpu().numpy().astype(np.float32)
        scale = np.maximum(np.max(np.abs(wn), axis=0) / 127.0, 1e-12)
        wq = np.clip(np.rint(wn / scale), -127, 127).astype(np.int8)
        out.append((torch.from_numpy(wq).to(w.device),
                    torch.from_numpy(scale.astype(np.float32)).to(w.device)))
    return out


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, at any shape."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _pad_to(m, 32), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp, np_) != (m, k, n):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _matmul_int8(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32."""
    lead = q.shape[:-1]
    return int_mm(q.reshape(-1, q.shape[-1]), wq).reshape(*lead, wq.shape[1])


def dense_int8(h, wq, w_scale):
    """Row-dynamic symmetric int8 x per-channel int8 -> float32, before
    the bias."""
    ax = torch.clamp_min(torch.amax(torch.abs(h), dim=-1, keepdim=True)
                         / 127.0, 1e-12)
    hq = torch.clamp(torch.round(h / ax), -127.0, 127.0).to(torch.int8)
    return _matmul_int8(hq, wq).to(torch.float32) * (ax * w_scale)


def dense_int8_nonneg(h, wq, w_scale):
    """Unsigned 8-bit activations of known non-negative rows (post-relu)
    on the signed int8 product, by the zero-point shift."""
    ax = torch.clamp_min(torch.amax(h, dim=-1, keepdim=True) / 255.0, 1e-12)
    sq = torch.clamp(torch.round(h / ax) - 128.0, -128.0, 127.0).to(
        torch.int8)
    colsum = torch.sum(wq.to(torch.int32), dim=0)
    return ((_matmul_int8(sq, wq) + 128 * colsum).to(torch.float32)
            * (ax * w_scale))


def fused_pointnet_int8(points, qweights, biases):
    """The int8 PointNet backbone: relu-dense chain with dynamic int8
    products, then the float32 max over the points. points (B, N, C)
    float32; qweights from ``quantize_weights_int8``; biases [(Cout,)]."""
    h = points.to(torch.float32)
    for i, ((wq, ws), b) in enumerate(zip(qweights, biases)):
        dense = dense_int8 if i == 0 else dense_int8_nonneg
        h = torch.clamp_min(dense(h, wq, ws) + b, 0.0)
    return torch.amax(h, dim=1)
