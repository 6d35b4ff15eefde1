"""The unfolded model's last options against the JAX package on the CPU:
``stack_siamese=False`` (the encoder once a view; the second call's BNs
start from the running statistics the first moved) and
``compute_dtype='bfloat16'`` (dense layers in bf16 over f32 parameters, BN
in f32, the kNN graph and the fused edge stage in f32, f32 outputs), for
the PointNet and the DGCNN (unfused, and fused through the edge stage's
plain version). Same weights, dropout keep 1.0, no jitter: the eval-mode
and train-mode end points, then one training step's loss, aux terms,
parameter gradients and BN statistics.

Tolerances: float32 as tests/test_torch_train_step.py and
tests/test_torch_model.py (eval end points and statistics rtol 1e-4 /
atol 1e-5, train-mode end points atol 1e-4: BN over a few rows amplifies
the summation-order gap; gradients 1e-3 relative L2 a leaf). bfloat16:
2e-2 relative (an end point's L2 against its norm, a leaf's relative L2),
at a batch of 16; one bf16 rounding is 2^-8 = 3.9e-3. The eval-mode
forward agrees exactly here. In train mode the DGCNN in bf16 is chaotic at
the rounding level: the two packages sum each BN's f32 statistics in
another order, which flips a few of the ~10^5 edge activations to the
neighbouring bf16 value, and the flips grow through the layers; the
backward of either backbone rounds its cotangents in bf16 layer by layer
the same way. There (the DGCNN's train-mode values, every bf16 gradient)
the port is held to 2e-2 or to twice the JAX model's own change when its
input moves by 1e-3 relative (below one bf16 step), whichever is
larger."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import NO_DROPOUT, _batch, _leaves
from torch_parity import to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models import losses as jl
from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu_torch.models import losses as tl
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.weights import from_flax, to_flax

POINTNET = ModelSpec(num_points=64, num_bins=8, s1_backbone=(16, 32),
                     s1_mlp=(32,), s2_backbone=(16, 32), s2_mlp=(32,),
                     embedding=(16, 64), remaining_mlp=(32,), **NO_DROPOUT)
DGCNN = ModelSpec(backbone="dgcnn", num_points=40, num_bins=8,
                  s1_backbone=(16, 32, 32), s1_mlp=(32,),
                  s2_backbone=(16, 32, 32), s2_mlp=(32,),
                  embedding=(16, 32, 32), remaining_mlp=(32,),
                  dgcnn_knn_impl="xla", **NO_DROPOUT)
SPECS = {
    "pointnet_unstacked": dataclasses.replace(POINTNET, stack_siamese=False),
    "dgcnn_unstacked": dataclasses.replace(DGCNN, stack_siamese=False),
    "pointnet_bf16": dataclasses.replace(POINTNET, compute_dtype="bfloat16"),
    "dgcnn_bf16": dataclasses.replace(DGCNN, compute_dtype="bfloat16"),
    "dgcnn_fused_bf16": dataclasses.replace(DGCNN, compute_dtype="bfloat16",
                                            dgcnn_fused_train=True),
    "pointnet_unstacked_bf16": dataclasses.replace(
        POINTNET, stack_siamese=False, compute_dtype="bfloat16"),
}
LOSS = dict(num_bins=8, accept_inverted_angle=True,
            composite_translation=True, flip_aware_composite=True)
MOMENTUM = 0.6


def _bf16(spec):
    return spec.compute_dtype == "bfloat16"


def _chaotic(spec):
    """Train mode of the bf16 DGCNN: held to the JAX model's own noise."""
    return _bf16(spec) and spec.backbone == "dgcnn"


def _close(got, want, spec, what, atol=1e-5, noisy=None):
    """``noisy``: the JAX value under the input perturbation, for the
    rounding-level noise rule of the bf16 DGCNN in train mode."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.isfinite(got)), what
    if _bf16(spec):
        scale = max(np.linalg.norm(want), 1e-3)
        tol = 2e-2
        if noisy is not None and _chaotic(spec):
            tol = max(tol, 2 * np.linalg.norm(np.asarray(noisy) - want)
                      / scale)
        err = np.linalg.norm(got - want)
        assert err <= tol * scale, (what, err, tol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                                   err_msg=what)


def _inputs(spec, seed):
    """A batch (16 pairs in bf16, 4 in f32) and its first cloud moved by
    1e-3 relative."""
    batch = _batch(spec, seed, b=16 if _bf16(spec) else 4)
    return batch, (batch[0] * np.float32(1 + 1e-3),) + batch[1:]


def _port(spec, variables):
    port = TorchAlignNet(torch_spec(spec))
    port.load_state_dict(from_flax(to_numpy_tree(variables)))
    return port


@pytest.mark.parametrize("name", list(SPECS))
def test_end_points_match_jax(name):
    spec = SPECS[name]
    model, variables = trained_variables(spec)
    batch, moved = _inputs(spec, 11)
    port = _port(spec, variables)
    tb = [torch.from_numpy(batch[0]), torch.from_numpy(batch[1])]
    want = model.apply(variables, jnp.asarray(batch[0]),
                       jnp.asarray(batch[1]), train=False)
    got = port.eval()(*tb)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == torch.float32, key
        _close(got[key].detach(), want[key], spec, f"eval {key}")

    def train(pcs1):
        return model.apply(variables, jnp.asarray(pcs1),
                           jnp.asarray(batch[1]), train=True,
                           momentum=MOMENTUM, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})

    (want, mut), (noisy, noisy_mut) = train(batch[0]), train(moved[0])
    got = port.train()(*tb, momentum=MOMENTUM)
    for key in want:
        _close(got[key].detach(), want[key], spec, f"train {key}",
               atol=1e-4, noisy=noisy[key])
    stats = dict(_leaves(to_flax(port.state_dict())["batch_stats"]))
    noisy_stats = dict(_leaves(to_numpy_tree(noisy_mut["batch_stats"])))
    for path, w in _leaves(to_numpy_tree(mut["batch_stats"])):
        _close(stats[path], w, spec, str(path), noisy=noisy_stats[path])


@pytest.mark.parametrize("name", list(SPECS))
def test_one_training_step_matches_jax(name):
    spec = SPECS[name]
    model, variables = trained_variables(spec)
    batch, moved = _inputs(spec, 3)
    jspec = jl.LossSpec(**LOSS)

    def step(inputs):
        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(inputs[0]), jnp.asarray(inputs[1]), train=True,
                momentum=MOMENTUM, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            loss, aux = jl.get_loss(*[jnp.asarray(a) for a in inputs], out,
                                    spec=jspec)
            return loss, (aux, mut["batch_stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    (want, (want_aux, want_stats)), want_grads = step(batch)
    noisy = step(moved) if _bf16(spec) else None

    port = _port(spec, variables).train()
    tb = [torch.from_numpy(a) for a in batch]
    got, got_aux = tl.get_loss(*tb, port(tb[0], tb[1], momentum=MOMENTUM),
                               spec=tl.LossSpec(**LOSS))
    params = dict(port.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
    assert all(g.dtype == torch.float32 for g in grads.values())
    got_tree = to_flax({**grads, **{
        k: v for k, v in port.state_dict().items()
        if k.rsplit(".", 1)[-1] in ("mean", "var")}})

    (n_loss, (n_aux, n_stats)), n_grads = noisy or ((None, (
        dict.fromkeys(want_aux), None)), None)
    _close(got.item(), float(want), spec, "loss", noisy=n_loss)
    for key in want_aux:
        _close(got_aux[key].item(), float(want_aux[key]), spec, key,
               noisy=n_aux[key])
    want_g = dict(_leaves(to_numpy_tree(want_grads)))
    got_g = dict(_leaves(got_tree["params"]))
    noisy_g = dict(_leaves(to_numpy_tree(n_grads))) if noisy else {}
    assert want_g.keys() == got_g.keys()
    # relative L2 per leaf, with a floor of 1% of the whole gradient's
    # norm for the biases a BN follows (true gradient 0, rounding noise)
    floor = 1e-2 * np.sqrt(sum(np.sum(w * w) for w in want_g.values()))
    for path, w in want_g.items():
        scale = max(np.linalg.norm(w), floor)
        rel = 2e-2 if _bf16(spec) else 1e-3
        shift = path[:-2] + ("bn" + path[-2][-1], "bias")
        if (_bf16(spec) and path[-1] == "bias" and shift in want_g
                and path[-2].startswith(("conv", "fc"))):
            # a bias that a BN follows has true gradient 0, and each side
            # holds the cancellation noise of its own sum of the bf16
            # cotangents: the JAX package's is 2-5% of the BN shift's
            # gradient, the port's (summed in f32) under 1% (ROADMAP.md,
            # Queue 3). The port must be no further from 0.
            assert np.linalg.norm(got_g[path]) <= max(
                np.linalg.norm(w), rel * scale), path
            continue
        if path in noisy_g:
            rel = max(rel, 2 * np.linalg.norm(noisy_g[path] - w) / scale)
        err = np.linalg.norm(got_g[path] - w)
        assert err <= rel * scale, (path, err, rel)
    stats = dict(_leaves(got_tree["batch_stats"]))
    noisy_s = dict(_leaves(to_numpy_tree(n_stats))) if noisy else {}
    for path, w in _leaves(to_numpy_tree(want_stats)):
        _close(stats[path], w, spec, str(path), noisy=noisy_s.get(path))
