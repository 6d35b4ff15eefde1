"""Plain PyTorch AlignNet: the benchmark's reference forward and loss.

Written from the model's description (AlignNet-3D, arXiv:1910.04668, and
its reference code's tp8.py) over the state dict of
``benchmark/inputs/weights.py``; each encoder backbone's forward is its own
file, ``benchmark/reference/backbones/<backbone>.py``, over the helpers
here. Nothing here comes from the program: no kernel, no fold, no
cache. Float32 with TF32 off; batch norms in eval mode use the running
statistics as they stand (the serving program folds them), in train mode
the batch's biased statistics (two-pass variance).

``precision("tf32")`` is the control: every dense product and every
distance product then rounds its operands to TF32 (10-bit mantissa,
round to nearest even) before the float32 product, as the tensor cores do
with TF32 on, on the CPU as on the card. ``precision("tf32_dense")`` rounds
the dense products alone and keeps the distances (the kNN graph, nearest
neighbours) in float32: a program that moves its layers' products, and not
its graph, to TF32.

A difference from a straight transcription, without effect on the
maths: squared distances (a backbone's kNN graph, nearest neighbours in
``serve``) are expanded as |a|^2 + |b|^2 - 2 a.b in a fixed order, so that
rounding picks between near-equal neighbours as a float32 implementation
of that formula does; neighbour ties go to the lower index.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import harness

BN_EPS = 1e-3
_STATE = {"precision": "float32"}


@contextlib.contextmanager
def precision(name: str):
    """'float32' (the reference), 'tf32' (the control) or 'tf32_dense'
    inside the block."""
    old = _STATE["precision"]
    _STATE["precision"] = name
    try:
        yield
    finally:
        _STATE["precision"] = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with every operand of the forward and backward products
    rounded to TF32; b is (k, m) or has a's batch dimensions."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, b.transpose(-1, -2))
        if b.dim() == 2:
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 (with TF32-rounded operands under the control)."""
    if _STATE["precision"] in ("tf32", "tf32_dense"):
        return _TF32Matmul.apply(a, b)
    return torch.matmul(a, b)


def dense(x, sd, name):
    return mm(x, sd[f"{name}.weight"].t()) + sd[f"{name}.bias"]


def batch_norm(x, sd, name, train: bool):
    dims = tuple(range(x.dim() - 1))
    if train:
        mean = x.mean(dims)
        var = torch.square(x - mean).mean(dims)
    else:
        mean, var = sd[f"{name}.mean"], sd[f"{name}.var"]
    return ((x - mean) * torch.rsqrt(var + BN_EPS) * sd[f"{name}.scale"]
            + sd[f"{name}.bias"])


def sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, n, 3), (B, m, 3) -> (B, n, m) squared distances |a|^2 + |b|^2 -
    2 a.b, each term rounded on its own: the cross term summed as
    ((a0 q0 + a1 q1) + a2 q2) with q = -2 b, then |a|^2 and |b|^2 added,
    clamped at 0. Under the control the cross term's operands are rounded
    to TF32, as a tensor-core product of them would be."""
    q = -2.0 * b
    if _STATE["precision"] == "tf32":
        a, q = tf32_round(a), tf32_round(q)
    d2 = a[..., 0, None] * q[:, None, :, 0]
    d2 = d2 + a[..., 1, None] * q[:, None, :, 1]
    d2 = d2 + a[..., 2, None] * q[:, None, :, 2]
    return torch.clamp_min(d2 + sq_norm(a)[..., None]
                           + sq_norm(b)[:, None, :], 0.0)


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
            + x[..., 2] * x[..., 2])


def head(x, sd, prefix, n_layers, train, dropout):
    for i in range(1, n_layers):
        x = torch.relu(batch_norm(dense(x, sd, f"{prefix}.fc{i}"), sd,
                                  f"{prefix}.bn{i}", train))
    if dropout is not None:
        x = dropout(x)
    return dense(x, sd, f"{prefix}.fc{n_layers}")


def logits_to_angle(logits, bins: int, scale: float):
    """Argmax bin (first on ties) + its residual * scale, in [-pi, pi)."""
    cls = torch.argmax(logits[..., :bins], dim=-1)
    res = torch.gather(logits[..., bins:], -1, cls[..., None])[..., 0] * scale
    angle = cls.to(torch.float32) * (2.0 * np.pi / bins) + res
    return torch.remainder(angle + np.pi, 2.0 * np.pi) - np.pi


def rotate_z(p, angle):
    """p @ Rz(angle) per sample: (x c + y s, -x s + y c, z)."""
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x, y = p[..., 0], p[..., 1]
    return torch.stack([x * c + y * s, -x * s + y * c, p[..., 2]], dim=-1)


class Model:
    """The AlignNet of a config's ``model`` section over a state dict; its
    backbone is ``reference/backbones/<backbone>.py`` under the state-dict
    name of ``backbones/<backbone>.py``."""

    def __init__(self, model_cfg: dict, sd: dict,
                 bench_dir=harness.BENCH_DIR):
        self.cfg = model_cfg
        self.sd = sd
        opts = model_cfg["options"]
        self.bins = model_cfg["angles"]["num_bins"]
        self.kind = model_cfg["backbone"]
        self.bb = harness.backbone(self.kind, bench_dir).MODULE
        self._backbone = harness.reference_backbone(self.kind,
                                                    bench_dir).forward
        self.sizes = {"transformer1": opts["s1transformer"],
                      "transformer2": opts["s2transformer"]}
        self.emb = opts["embedding"]
        self.rem = opts["remaining_transform_prediction"]

    def backbone(self, x, prefix, n, train):
        return self._backbone(x, self.sd, prefix, n, train)

    def transformer(self, x, name, train, dropout):
        sizes, (mlp, keep) = self.sizes[name]
        feat = self.backbone(x, f"siamese.{name}.{self.bb}", len(sizes), train)
        return head(feat, self.sd, f"siamese.{name}.MLPHead_0", len(mlp) + 1,
                    train, dropout and (lambda h: dropout(h, keep)))

    def embed(self, points, train, dropout):
        cm = points.mean(1)
        s1 = self.transformer(points - cm[:, None], "transformer1", train,
                              dropout) + cm
        s2_out = self.transformer(points - s1[:, None], "transformer2", train,
                                  dropout)
        s2 = s2_out[:, :3] + s1
        logits = s2_out[:, 3:]
        angles = logits_to_angle(logits, self.bins, np.pi / self.bins)
        normalized = rotate_z(points - s2[:, None], -angles)
        emb = self.backbone(normalized, f"siamese.{self.bb}", len(self.emb),
                            train)
        return emb, s1, s2, logits

    def forward(self, pcs1, pcs2, train: bool = False, dropout=None):
        """The end points of the pair batch. ``dropout(h, keep)`` (train
        mode) applies a dropout mask drawn by the caller."""
        b = pcs1.shape[0]
        emb, s1, s2, logits = self.embed(torch.cat([pcs1, pcs2]), train,
                                         dropout)
        mlp, keep = self.rem
        out = head(torch.cat([emb[:b], emb[b:]], -1), self.sd, "remaining",
                   len(mlp) + 1, train,
                   dropout and (lambda h: dropout(h, keep)))
        return {"pred_s1_pc1centers": s1[:b], "pred_s1_pc2centers": s1[b:],
                "pred_s2_pc1centers": s2[:b], "pred_s2_pc2centers": s2[b:],
                "pred_pc1angle_logits": logits[:b],
                "pred_pc2angle_logits": logits[b:],
                "pred_translations": out[:, :3] + (s2[b:] - s2[:b]),
                "pred_remaining_angle_logits": out[:, 3:]}


# ------------------------------------------------------------------ loss


def _huber(err, delta):
    a = torch.abs(err)
    q = torch.clamp(a, max=delta)
    return torch.mean(0.5 * q * q + delta * (a - q))


def _angle2class(angle, bins):
    angle = torch.remainder(angle, 2.0 * np.pi)
    width = 2.0 * np.pi / bins
    shifted = torch.remainder(angle + width / 2.0, 2.0 * np.pi)
    cls = (shifted / width).to(torch.int64)
    return cls, shifted - (cls.to(angle.dtype) * width + width / 2.0)


def _angle_loss(logits, target, bins):
    cls, res = _angle2class(target, bins)
    logp = F.log_softmax(logits[:, :bins], dim=-1)
    class_loss = torch.mean(-torch.gather(logp, 1, cls[:, None])[:, 0])
    pred_res = torch.gather(logits[:, bins:], 1, cls[:, None])[:, 0]
    res_loss = _huber(pred_res - res / (np.pi / bins), 1.0)
    return class_loss + 20.0 * res_loss


def _angle_losses(logits, target, bins, accept_inverted):
    loss = _angle_loss(logits, target, bins)
    if accept_inverted:
        # the reference keeps the LARGER of the two (tp8.py:288)
        loss180 = _angle_loss(logits, target + np.pi, bins)
        loss = torch.where(loss > loss180, loss, loss180)
    return loss


def loss_separate(out, labels, model_cfg: dict, loss_options: dict):
    """The multi-stage loss of tp8.py:304-354 (per-transform: the batch
    mean divided by the batch size again), with the options
    ``composite_translation`` and ``flip_aware_composite``."""
    t, rel, c1, c2, a1, a2 = labels
    bins = model_cfg["angles"]["num_bins"]
    inverted = model_cfg["angles"]["accept_inverted_angle"]
    opts = model_cfg["options"]
    scale = np.pi / bins
    s1_t = 0.5 * (_huber(out["pred_s1_pc1centers"] - c1, 1.0)
                  + _huber(out["pred_s1_pc2centers"] - c2, 1.0))
    s2_t = 0.5 * (_huber(out["pred_s2_pc1centers"] - c1, 1.0)
                  + _huber(out["pred_s2_pc2centers"] - c2, 1.0))
    s2_a = 0.5 * (
        _angle_losses(out["pred_pc1angle_logits"], a1, bins, inverted)
        + _angle_losses(out["pred_pc2angle_logits"], a2, bins, inverted))
    p1 = logits_to_angle(out["pred_pc1angle_logits"], bins, scale)
    p2 = logits_to_angle(out["pred_pc2angle_logits"], bins, scale)
    if loss_options.get("composite_translation", False):
        rebase = rel
        if loss_options.get("flip_aware_composite", False):
            pr = logits_to_angle(out["pred_remaining_angle_logits"], bins,
                                 scale)
            diff = torch.remainder((p2 - p1) + pr - rel + np.pi,
                                   2.0 * np.pi) - np.pi
            rebase = rel + np.pi * (torch.abs(diff) > np.pi / 2).to(rel.dtype)
        s = c1 - out["pred_s2_pc1centers"]
        ca, sa = torch.cos(rebase), torch.sin(rebase)
        rot_s = torch.stack([ca * s[:, 0] - sa * s[:, 1],
                             sa * s[:, 0] + ca * s[:, 1], s[:, 2]], dim=1)
        s3_t = _huber(out["pred_translations"] - s + rot_s - t, 2.0)
    else:
        s3_t = _huber(out["pred_translations"] - t, 2.0)
    a3 = _angle_losses(out["pred_remaining_angle_logits"],
                       (a2 - a1) - (p2 - p1), bins, inverted)
    esf = opts["early_stage_factor"]
    loss = (esf * (s1_t + s2_t) + s3_t
            + opts["angle_factor"] * (esf * s2_a + a3))
    return loss / t.shape[0]


def adam_step(params: dict, grads: dict, state: dict, lr: float,
              betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam update in place (Kingma & Ba, with bias corrections)."""
    step = state.get("step", 0) + 1
    state["step"] = step
    b1, b2 = betas
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g))
        v = state.setdefault(("v", k), torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
        params[k].addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
