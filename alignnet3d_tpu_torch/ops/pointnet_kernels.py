"""Fused BN-folded PointNet chain + max over points.

Counterpart of ``alignnet3d_tpu/ops/pointnet_kernels.py``. At serving time
every BatchNorm folds into its dense layer, so a PointNet backbone is
``max_N relu(... relu(x W1 + b1) ... W_L + b_L)``. The CUDA kernel
(``csrc/fused_pointnet.cu``) runs the whole chain with the activations in
shared memory; ``fused_pointnet_plain`` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's reference on the card.

``compute_dtype=torch.bfloat16`` follows the JAX package's bf16 serving
semantics: the operands are rounded to bf16, the products accumulate in
f32, and every activation is rounded back to bf16 after its relu. Both
versions compute this on f32 tensors holding bf16 values.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

MAX_LAYERS = 4
MAX_HIDDEN = 256  # widest input of any layer the kernel takes


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    if compute_dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    if compute_dtype != torch.float32:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    return x


def fused_pointnet_plain(points: torch.Tensor,
                         weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """points (B, N, C); weights[i] (C_i, C_{i+1}); biases[i] (C_{i+1},).
    Returns (B, F_last) float32."""
    h = round_to(points.to(torch.float32), compute_dtype)
    for w, b in zip(weights, biases):
        h = torch.clamp_min(torch.matmul(h, round_to(w, compute_dtype)) + b, 0.0)
        h = round_to(h, compute_dtype)
    return torch.amax(h, dim=1)


def _check(points, weights, biases, compute_dtype):
    if points.device.type != "cuda":
        raise ValueError(f"fused_pointnet: unsupported device {points.device}")
    if points.dtype != torch.float32 or points.dim() != 3:
        raise ValueError("fused_pointnet: points must be (B, N, C) float32")
    if not points.is_contiguous():
        raise ValueError("fused_pointnet: points must be contiguous")
    b, n, c = points.shape
    if b < 1 or n < 1 or b > 65535:
        raise ValueError(f"fused_pointnet: unsupported shape {tuple(points.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(f"fused_pointnet: 1..{MAX_LAYERS} layers, one bias each")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    dims = [c]
    for w, bias in zip(weights, biases):
        if (w.device != points.device or bias.device != points.device
                or w.dtype != torch.float32 or bias.dtype != torch.float32):
            raise ValueError("fused_pointnet: weights and biases must be "
                             "float32 on the points' device")
        if (w.dim() != 2 or w.shape[0] != dims[-1]
                or tuple(bias.shape) != (w.shape[1],)):
            raise ValueError("fused_pointnet: weight/bias shapes do not chain")
        if not (w.is_contiguous() and bias.is_contiguous()):
            raise ValueError("fused_pointnet: weights must be contiguous")
        dims.append(int(w.shape[1]))
    if max(dims[:-1]) > MAX_HIDDEN:
        raise ValueError(
            f"fused_pointnet: layer inputs wider than {MAX_HIDDEN}: {dims}")
    return dims


def fused_pointnet(points: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused chain: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Returns (B, F_last) float32."""
    if points.device.type == "cpu":
        return fused_pointnet_plain(points, weights, biases, compute_dtype)
    dims = _check(points, weights, biases, compute_dtype)
    from alignnet3d_tpu_torch.ops._build import load_library

    lib = load_library()
    ws = [round_to(w, compute_dtype).contiguous() for w in weights]
    out = torch.empty((points.shape[0], dims[-1]), dtype=torch.float32,
                      device=points.device)
    n_layers = len(ws)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.fused_pointnet_launch(
            points.data_ptr(), points.shape[0], points.shape[1], n_layers,
            (ctypes.c_int * (n_layers + 1))(*dims),
            (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws]),
            (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in biases]),
            int(compute_dtype == torch.bfloat16), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_pointnet: kernel launch failed, CUDA error {rc}")
    fused_pointnet.launches += 1
    return out


fused_pointnet.launches = 0
