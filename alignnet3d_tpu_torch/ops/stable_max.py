"""Max and min reductions whose gradient goes to the FIRST arg-extremum.

Counterpart of ``alignnet3d_tpu/ops/stable_max.py``. ``torch.amax`` (like
``jnp.max``) splits the cotangent evenly over tied maxima; ``stable_max``
gives all of it to the first index that attains the max, the rule the
fused training edge stage (``edge_train_kernels``) routes its max over k
by. The forward value is the max either way.

The JAX module exists because ``jit(grad)`` of ``jnp.max`` can drop
cotangents under rematerialisation; PyTorch runs eagerly and has no such
failure, so here the point is the routing rule: it backs
``model.options.stable_max_grad`` (the training graph's pools) and the
plain twin of the fused training kernel.
"""

from __future__ import annotations

import torch


class _StableMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        # argmax returns the first index of the max
        idx = torch.argmax(x, dim=dim, keepdim=True)
        ctx.save_for_backward(idx)
        ctx.dim = dim
        ctx.shape = x.shape
        return torch.gather(x, dim, idx).squeeze(dim)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        out.scatter_(ctx.dim, idx, grad.unsqueeze(ctx.dim))
        return out, None


def stable_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.amax(x, dim)`` whose gradient goes to the first argmax."""
    return _StableMax.apply(x, dim % x.dim())


def stable_min(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.amin(x, dim)`` whose gradient goes to the first argmin
    (negation is exact for floats)."""
    return -stable_max(-x, dim)
