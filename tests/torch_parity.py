"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

The tier-1 run spreads the test files over several worker processes, so
each worker's torch keeps to one thread. Weights come from the JAX
package's ``AlignNet.init`` plus a few train-mode steps (non-trivial BN
statistics) and reach the port through the weight bridge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu_torch.models.alignnet import ModelSpec as TorchModelSpec

torch.set_num_threads(1)

SPEC = ModelSpec(
    num_points=128, num_bins=8,
    s1_backbone=(16, 32), s1_mlp=(32,),
    s2_backbone=(16, 32), s2_mlp=(32,),
    embedding=(16, 64), remaining_mlp=(32,),
)


def torch_spec(spec: ModelSpec) -> TorchModelSpec:
    """The port's ModelSpec with the same field values."""
    return TorchModelSpec(**dataclasses.asdict(spec))


def trained_variables(spec: ModelSpec = SPEC, steps: int = 3, seed: int = 0):
    """(model, variables) with BN statistics moved by ``steps`` train-mode
    passes at momentum 0.5, as tests/test_serving.py makes them."""
    model = AlignNet(spec)
    x = jnp.zeros((4, spec.num_points, 3))
    variables = model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        x, x, train=False,
    )
    rng = np.random.default_rng(seed)
    for i in range(steps):
        a = jnp.asarray(rng.normal(size=(4, spec.num_points, 3)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(4, spec.num_points, 3)), jnp.float32)
        _, mut = model.apply(
            variables, a, b, train=True, momentum=0.5,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(i)},
        )
        variables = {"params": variables["params"],
                     "batch_stats": mut["batch_stats"]}
    return model, variables


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
