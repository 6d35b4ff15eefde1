"""Weights: the bridge to and from the flax variables tree, and a seeded
init of the port's own.

The flax tree is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays. The port's module tree carries the flax names, so a flax path
maps onto a ``state_dict`` key by joining it with dots; only the leaves are
renamed:

    params/.../conv1/kernel  (in, out)  <->  ....conv1.weight  (out, in)
    params/.../conv1/bias                <->  ....conv1.bias
    params/.../bn1/{scale,bias}          <->  ....bn1.{scale,bias}
    batch_stats/.../bn1/{mean,var}       <->  ....bn1.{mean,var}
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from alignnet3d_tpu_torch.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu_torch.models.batchnorm import EmaBatchNorm

_STATS = ("mean", "var")


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax(variables) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> torch ``state_dict``."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[collection]):
            arr = np.asarray(leaf)
            *mods, name = path
            if name == "kernel":
                name, arr = "weight", arr.T
            state[".".join((*mods, name))] = torch.tensor(arr)
    return state


def to_flax(state_dict) -> dict:
    """torch ``state_dict`` -> flax ``{"params", "batch_stats"}`` tree of
    numpy arrays."""
    variables = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *mods, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        collection = "batch_stats" if name in _STATS else "params"
        if name == "weight":
            name, arr = "kernel", arr.T
        node = variables[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return variables


def init_state_dict(spec: ModelSpec, seed: int) -> dict[str, torch.Tensor]:
    """Seeded port-native init, as the JAX package's (backbones.py:39-49):
    xavier-uniform dense kernels, zero biases, BN scale 1 and bias 0,
    running mean 0 and var 1."""
    gen = torch.Generator().manual_seed(seed)
    model = AlignNet(spec)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                fan_out, fan_in = module.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                module.weight.uniform_(-bound, bound, generator=gen)
                module.bias.zero_()
            elif isinstance(module, EmaBatchNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
