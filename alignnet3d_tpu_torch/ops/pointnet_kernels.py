"""Fused BN-folded PointNet chain + max over points.

Counterpart of ``alignnet3d_tpu/ops/pointnet_kernels.py``. At serving time
every BatchNorm folds into its dense layer, so a PointNet backbone is
``max_N relu(... relu(x W1 + b1) ... W_L + b_L)``. The CUDA kernel
(``csrc/fused_pointnet.cu``) runs the whole chain with the activations in
shared memory; ``fused_pointnet_plain`` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's reference on the card.
Both propagate a NaN through the relus and the max, as the JAX package's
``jnp.maximum``/``jnp.max`` do.

``compute_dtype=torch.bfloat16`` follows the JAX package's bf16 serving
semantics: the operands are rounded to bf16, the products accumulate in
f32, and every activation is rounded back to bf16 after its relu. Both
versions compute this on f32 tensors holding bf16 values.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from alignnet3d_tpu_torch.ops._batch import batch_chunks

MAX_LAYERS = 4
MAX_HIDDEN = 256  # widest input of any layer the kernel takes


def _compute_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


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
    if b < 1 or n < 1:
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


@torch.library.custom_op("alignnet3d_torch::fused_pointnet", mutates_args=(),
                         device_types="cuda")
def _fused_pointnet_op(points: torch.Tensor, weights: list[torch.Tensor],
                       biases: list[torch.Tensor], bf16: bool) -> torch.Tensor:
    """The op's CUDA impl: one launch of the kernel per slice of at most
    ``MAX_CLOUDS`` clouds, counted once a call."""
    compute_dtype = _compute_dtype(bf16)
    dims = _check(points, weights, biases, compute_dtype)
    from alignnet3d_tpu_torch.ops._build import load_library

    lib = load_library()
    ws = [round_to(w, compute_dtype).contiguous() for w in weights]
    out = torch.empty((points.shape[0], dims[-1]), dtype=torch.float32,
                      device=points.device)
    n_layers = len(ws)
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_ws = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws])
    c_bs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        for s, e in batch_chunks(points.shape[0]):
            rc = lib.fused_pointnet_launch(
                points[s:e].data_ptr(), e - s, points.shape[1], n_layers,
                c_dims, c_ws, c_bs, int(bf16), out[s:e].data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"fused_pointnet: kernel launch failed, CUDA error {rc}")
    fused_pointnet.launches += 1
    return out


@_fused_pointnet_op.register_kernel("cpu")
def _fused_pointnet_cpu(points, weights, biases, bf16):
    return fused_pointnet_plain(points, weights, biases, _compute_dtype(bf16))


@_fused_pointnet_op.register_fake
def _fused_pointnet_fake(points, weights, biases, bf16):
    return points.new_empty((points.shape[0], weights[-1].shape[1]),
                            dtype=torch.float32)


def fused_pointnet(points: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused chain through the op ``alignnet3d_torch::fused_pointnet``:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor;
    any other device is refused. Returns (B, F_last) float32."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if points.device.type not in ("cpu", "cuda"):
        _check(points, weights, biases, compute_dtype)  # raises
    return _fused_pointnet_op(points, list(weights), list(biases),
                              compute_dtype == torch.bfloat16)


fused_pointnet.launches = 0
