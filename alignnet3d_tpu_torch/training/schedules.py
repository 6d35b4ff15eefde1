"""Learning-rate and BN-momentum schedules, as functions of the integer
optimizer step.

Counterpart of ``alignnet3d_tpu/training/schedules.py`` (reference
train.py:133-174): staircase exponential decay driven by
``step * batch_size``, the decay interval optionally counted in epochs,
the LR floored at 1e-5, and the BN momentum ``min(clip, 1 - init * rate^k)``
rising from 0.5 towards ``clip``. The arithmetic is float32 in the same
order as the JAX functions', so both give the same value at every step.
"""

from __future__ import annotations

import numpy as np


def _decay_interval(ext, batch_size: int, num_batches_per_epoch: int) -> float:
    step = ext.step
    if ext.per == "epoch":
        step = step * batch_size * num_batches_per_epoch
    elif ext.per != "step":
        raise ValueError(f"unknown schedule per={ext.per!r}")
    return float(step)


def _stair(step: int, ext, cfg, num_batches_per_epoch: int) -> np.float32:
    interval = _decay_interval(ext, cfg.training.batch_size,
                               num_batches_per_epoch)
    return np.floor(np.float32(step) * np.float32(cfg.training.batch_size)
                    / np.float32(interval))


def learning_rate(step: int, cfg, num_batches_per_epoch: int) -> float:
    """Staircase exp decay with a 1e-5 floor (reference train.py:133-156)."""
    ext = cfg.training.lr_extension
    if ext.mode != "decay":
        raise ValueError(f"unsupported lr mode {ext.mode!r}")
    k = _stair(step, ext, cfg, num_batches_per_epoch)
    lr = np.float32(cfg.training.learning_rate) * np.power(np.float32(ext.rate), k)
    return float(np.maximum(lr, np.float32(1e-5)))


def bn_decay(step: int, cfg, num_batches_per_epoch: int) -> float:
    """EMA momentum schedule ``min(clip, 1 - init * rate^k)`` (reference
    train.py:159-174)."""
    ext = cfg.training.bn_extension
    if ext.mode != "decay":
        raise ValueError(f"unsupported bn mode {ext.mode!r}")
    k = _stair(step, ext, cfg, num_batches_per_epoch)
    momentum = np.float32(ext.init) * np.power(np.float32(ext.rate), k)
    return float(np.minimum(np.float32(ext.clip), np.float32(1.0) - momentum))
