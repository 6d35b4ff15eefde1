"""Batch normalisation with the reference's EMA-with-scheduled-decay
semantics (reference utils/tf_util.py:455-492, train.py:159-174).

Counterpart of ``alignnet3d_tpu/models/batchnorm.py``:

- in training, activations are normalised with the CURRENT batch's biased
  statistics, and the running averages move by
  ``ema = m * ema + (1 - m) * batch`` with the scheduled momentum ``m``
  passed at call time;
- in eval, the running statistics are used;
- ``eps = 1e-3``; the running variance starts at 1 (the reference's
  starts at 0; see the JAX module's docstring).

The parameter and buffer names (``scale``, ``bias``, ``mean``, ``var``)
are the flax leaf names, which keeps the weight bridge mechanical.

The statistics are computed in float32 and the output is cast back to the
input's dtype (bf16 under ``tpu.compute_dtype: "bfloat16"``). With several
processes (``parallel/multihost.py``) the train-mode statistics are those
of the global batch, as under the JAX package's data-parallel mesh: every
process's (sum, sum of squares) go through a differentiable all-reduce,
so the EMA update agrees on every process.
"""

from __future__ import annotations

import torch
from torch import nn

from alignnet3d_tpu_torch.parallel import multihost


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Biased batch statistics over all axes but the last (tf.nn.moments:
    E[x^2] - E[x]^2), over the global batch when several processes share
    it (each process holds the same number of rows)."""
    dims = tuple(range(x.dim() - 1))
    if multihost.process_count() == 1:
        mean = torch.mean(x, dim=dims)
        return mean, torch.mean(torch.square(x), dim=dims) - torch.square(mean)
    count = x.numel() // x.shape[-1] * multihost.process_count()
    sums = multihost.all_reduce_sum(torch.stack(
        [torch.sum(x, dim=dims), torch.sum(torch.square(x), dim=dims)]))
    mean = sums[0] / count
    return mean, sums[1] / count - torch.square(mean)


class EmaBatchNorm(nn.Module):
    """BatchNorm over all axes but the last, with a call-time EMA momentum."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean, var = batch_moments(xf)
            self.ema_update(mean, var, momentum)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)

    @torch.no_grad()
    def ema_update(self, mean: torch.Tensor, var: torch.Tensor,
                   momentum: float) -> None:
        """``ema = m * ema + (1 - m) * batch`` for the running statistics;
        also fed by the fused training edge stage's batch statistics."""
        m = torch.tensor(momentum, dtype=torch.float32, device=mean.device)
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)
