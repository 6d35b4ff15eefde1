"""Plain reference of the first training steps: batch draw, jitter,
dropout, train-mode forward, loss, gradients and Adam.

Every random draw is worked out again from the seeds the benchmark handed
to the trainer:

- the batch (the dataset layout's native assembler rule): per batch two
  seeds ``integers(0, 2**63, 2)`` of the batch generator, one a view; point
  i of sample b of packed row r is ``floor(splitmix64(ctr + i) * count /
  2**64)`` with ``ctr = splitmix64(seed ^ splitmix64((r << 32) ^ b ^
  0xA5A5A5A5DEADBEEF))``; the rows are the file indices, which the
  benchmark writes contiguously;
- the jitter: ``randn`` of each view's (B, N, 3), first then second, from a
  device generator seeded ``trainer seed + 2``, times 0.01, clipped at 0.05;
- dropout: ``rand`` of each head's input, in the order the heads run
  (transformer1, transformer2, remaining), from a device generator seeded
  ``trainer seed + 3``, kept below ``keep`` and scaled by 1 / keep;
- the learning rate: ``lr * rate ** floor(step * B / (step_epochs * B *
  batches_per_epoch))`` in float32, floored at 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model import Model, adam_step, loss_separate

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_LO32 = np.uint64(0xFFFFFFFF)


def _splitmix64(x):
    x = x + _GAMMA
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def resample_rows(points, offsets, counts, rows, num_points, seed):
    """(B, num_points, 3) float32 of the packed rows, drawn from ``seed``."""
    c = counts[rows]
    with np.errstate(over="ignore"):
        ctr = _splitmix64(np.uint64(seed) ^ _splitmix64(
            (rows.astype(np.uint64) << np.uint64(32))
            ^ np.arange(len(rows), dtype=np.uint64)
            ^ np.uint64(0xA5A5A5A5DEADBEEF)))
        r = _splitmix64(ctr[:, None]
                        + np.arange(num_points, dtype=np.uint64)[None, :])
        cu = c.astype(np.uint64)[:, None]
        hi, lo = r >> np.uint64(32), r & _LO32
        pick = ((hi * cu + ((lo * cu) >> np.uint64(32)))
                >> np.uint64(32)).astype(np.int64)
    return points[offsets[rows][:, None] + pick].astype(np.float32)


def learning_rate(step, training: dict, batches_per_epoch: int) -> float:
    ext = training["lr_extension"]
    bs = training["batch_size"]
    interval = float(ext["step"] * bs * batches_per_epoch
                     if ext["per"] == "epoch" else ext["step"])
    k = np.floor(np.float32(step) * np.float32(bs) / np.float32(interval))
    lr = np.float32(training["learning_rate"]) * np.power(
        np.float32(ext["rate"]), k)
    return float(np.maximum(lr, np.float32(1e-5)))


def first_steps(cfg: dict, weights: dict, scenes, batches,
                data_rng: np.random.Generator, trainer_seed: int, device,
                steps: int = 3):
    """Run ``steps`` steps on the index batches ``batches`` (lists of file
    indices), the batch seeds drawn from ``data_rng`` as the program drew
    them. Returns (losses [steps], first gradients {leaf: tensor},
    parameters after the steps {leaf: tensor}); parameters are the state
    dict's leaves other than the running statistics."""
    model_cfg, training = cfg["model"], cfg["training"]
    points = {k: np.concatenate([s[k] for s in scenes]) for k in (0, 1)}
    counts = {k: np.asarray([len(s[k]) for s in scenes], np.int64)
              for k in (0, 1)}
    offsets = {k: np.concatenate([[0], np.cumsum(counts[k])[:-1]])
               for k in (0, 1)}
    labels_all = [np.asarray([s[2][key] for s in scenes], np.float64)
                  for key in ("translation", "rel_angle", "start_position",
                              "end_position", "start_angle", "end_angle")]
    n = model_cfg["num_points"]
    bpe = max(1, cfg["train_pairs"] // training["batch_size"])
    jitter = torch.Generator(device).manual_seed(trainer_seed + 2)
    drop = torch.Generator(device).manual_seed(trainer_seed + 3)

    def dropout(h, keep):
        u = torch.rand(h.shape, generator=drop, device=device)
        return torch.where(u < keep, h / keep, torch.zeros_like(h))

    params = {k: v.detach().clone().to(device) for k, v in weights.items()
              if not k.endswith((".mean", ".var"))}
    stats = {k: v.to(device) for k, v in weights.items()
             if k.endswith((".mean", ".var"))}
    opt_state: dict = {}
    losses, first_grads = [], None
    for step in range(steps):
        rows = np.asarray(batches[step], np.int64)
        seeds = data_rng.integers(0, 2 ** 63, 2)
        pcs = [torch.as_tensor(resample_rows(points[k], offsets[k], counts[k],
                                             rows, n, int(seeds[k])),
                               device=device) for k in (0, 1)]
        pcs = [p + torch.clamp(0.01 * torch.randn(p.shape, generator=jitter,
                                                  device=device), -0.05, 0.05)
               for p in pcs]
        labels = [torch.as_tensor(a[rows], dtype=torch.float32, device=device)
                  for a in labels_all]
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        model = Model(model_cfg, {**leaves, **stats})
        out = model.forward(pcs[0], pcs[1], train=True, dropout=dropout)
        loss = loss_separate(out, labels, model_cfg,
                             training["loss"].get("options", {}))
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        params = {k: v.detach() for k, v in leaves.items()}
        with torch.no_grad():
            adam_step(params, grads, opt_state,
                      learning_rate(step, training, bpe))
        del out, loss, grads, model
    return losses, first_grads, params
