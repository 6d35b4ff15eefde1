"""Seeded weights in the port's state-dict key layout, made on the device.

The rule is frozen here: xavier-uniform dense kernels (bound
sqrt(6 / (fan_in + fan_out))), zero dense biases, and every batch norm's
scale and running variance drawn in [0.5, 2) and its bias and running mean
in [-0.2, 0.2), so that folding the statistics changes every layer. All
values come from one ``torch.rand`` call of a generator on the device,
sliced in ``layout`` order. The key names are the port's module tree
(``siamese.transformer1.PointNetBackbone_0.conv1.weight`` ...); the plain
reference reads the same dictionary.
"""

from __future__ import annotations

import math

import torch

BACKBONES = {"pointnet": "PointNetBackbone_0", "dgcnn": "DGCNNBackbone_0"}


def _chain(prefix, widths, dense, with_bn_last=True):
    out = []
    n = len(widths) - 1
    for i in range(n):
        name = f"{prefix}.{dense}{i + 1}"
        out.append((f"{name}.weight", (widths[i + 1], widths[i]), "weight"))
        out.append((f"{name}.bias", (widths[i + 1],), "bias"))
        if i < n - 1 or with_bn_last:
            bn = f"{prefix}.bn{i + 1}"
            for leaf in ("scale", "bias", "mean", "var"):
                out.append((f"{bn}.{leaf}", (widths[i + 1],), "bn_" + leaf))
    return out


def layout(model: dict):
    """[(key, shape, kind)] of the AlignNet of a config's ``model`` section:
    kind is weight, bias or bn_{scale,bias,mean,var}."""
    opts = model["options"]
    bins = model["angles"]["num_bins"]
    bb = BACKBONES[model["backbone"]]
    cin = 6 if model["backbone"] == "dgcnn" else 3
    s1, (s1_mlp, _) = opts["s1transformer"]
    s2, (s2_mlp, _) = opts["s2transformer"]
    emb = opts["embedding"]
    rem_mlp, _ = opts["remaining_transform_prediction"]
    out = []
    for name, sizes, mlp, head in (("transformer1", s1, s1_mlp, 3),
                                   ("transformer2", s2, s2_mlp, 3 + 2 * bins)):
        out += _chain(f"siamese.{name}.{bb}", (cin, *sizes), "conv")
        out += _chain(f"siamese.{name}.MLPHead_0", (sizes[-1], *mlp, head),
                      "fc", with_bn_last=False)
    out += _chain(f"siamese.{bb}", (cin, *emb), "conv")
    out += _chain("remaining", (2 * emb[-1], *rem_mlp, 3 + 2 * bins), "fc",
                  with_bn_last=False)
    return out


def seeded(model: dict, seed: int, device) -> dict:
    """{key: float32 tensor on ``device``} by the frozen rule."""
    keys = layout(model)
    total = sum(math.prod(shape) for _, shape, kind in keys if kind != "bias")
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape, kind in keys:
        if kind == "bias":
            state[key] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        x = u[at:at + n].reshape(shape)
        at += n
        if kind == "weight":
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            state[key] = (2.0 * x - 1.0) * bound
        elif kind in ("bn_scale", "bn_var"):
            state[key] = 0.5 + 1.5 * x
        else:
            state[key] = -0.2 + 0.4 * x
    return state
