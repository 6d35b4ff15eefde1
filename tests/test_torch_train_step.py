"""One training step of the port against the JAX package on the CPU, at
the same weights and batch, dropout keep 1.0 and no jitter: the loss, every
``aux`` term, every parameter gradient and the new BN statistics, for the
PointNet and for the DGCNN with ``dgcnn_fused_train`` (the fused stage's
twin here, the Pallas kernel in interpret mode there). The JAX gradients
are taken eagerly (``jax.value_and_grad`` without ``jit``), as
ops/stable_max.py advises. Also: ``DGCNNBackbone(fused_train=True)``
against flax (the parity test of tests/test_edge_train_kernels.py), and
the weight bridge on a fused DGCNN."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models import losses as jl
from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu.models.backbones import DGCNNBackbone as JaxDGCNN
from alignnet3d_tpu_torch.models import losses as tl
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.models.backbones import DGCNNBackbone
from alignnet3d_tpu_torch.weights import from_flax, to_flax

NO_DROPOUT = dict(s1_dropout_keep=1.0, s2_dropout_keep=1.0,
                  remaining_dropout_keep=1.0)
SPECS = {
    "pointnet": dataclasses.replace(SPEC, **NO_DROPOUT),
    "dgcnn_fused": ModelSpec(
        backbone="dgcnn", num_points=48, num_bins=8,
        s1_backbone=(16, 32, 32), s1_mlp=(32,),
        s2_backbone=(16, 32, 32), s2_mlp=(32,),
        embedding=(16, 32, 32), remaining_mlp=(32,),
        dgcnn_knn_impl="xla", dgcnn_fused_train=True, **NO_DROPOUT),
}
LOSS = dict(num_bins=8, accept_inverted_angle=True,
            composite_translation=True, flip_aware_composite=True)
MOMENTUM = 0.6


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _batch(spec, seed, b=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(b, spec.num_points, 3), f(b, spec.num_points, 3) + 1.0,
            f(b, 3), f(b, 1), f(b, 3) * 0.3, f(b, 3) * 0.3 + 1.0, f(b, 1),
            f(b, 1))


@pytest.mark.parametrize("name", list(SPECS))
def test_one_training_step_matches_jax(name):
    spec = SPECS[name]
    model, variables = trained_variables(spec)
    batch = _batch(spec, 3)
    jspec = jl.LossSpec(**LOSS)

    def loss_fn(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch[0]), jnp.asarray(batch[1]), train=True,
            momentum=MOMENTUM, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        loss, aux = jl.get_loss(*[jnp.asarray(a) for a in batch], out,
                                spec=jspec)
        return loss, (aux, mut["batch_stats"])

    (want, (want_aux, want_stats)), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    port = TorchAlignNet(torch_spec(spec)).train()
    port.load_state_dict(from_flax(to_numpy_tree(variables)))
    tb = [torch.from_numpy(a) for a in batch]
    out = port(tb[0], tb[1], momentum=MOMENTUM)
    got, got_aux = tl.get_loss(*tb, out, spec=tl.LossSpec(**LOSS))
    params = dict(port.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
    got_tree = to_flax({**{k: g for k, g in grads.items()},
                        **{k: v for k, v in port.state_dict().items()
                           if k.rsplit(".", 1)[-1] in ("mean", "var")}})

    # f32 on the CPU in both packages; the heads' train-mode BN over 4-8
    # rows amplifies the summation-order gap (tests/test_torch_model.py)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for key in want_aux:
        np.testing.assert_allclose(got_aux[key].item(), float(want_aux[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    want_g = dict(_leaves(to_numpy_tree(want_grads)))
    got_g = dict(_leaves(got_tree["params"]))
    assert want_g.keys() == got_g.keys()
    # relative L2 per leaf. A bias that a BN follows has true gradient 0
    # and both sides hold f32 noise there (~1e-6): such a leaf is held to
    # a floor of 1% of the whole gradient's norm
    floor = 1e-2 * np.sqrt(sum(np.sum(w * w) for w in want_g.values()))
    for path, w in want_g.items():
        err = np.linalg.norm(got_g[path] - w)
        assert err <= 1e-3 * max(np.linalg.norm(w), floor), (path, err)
    for path, w in _leaves(to_numpy_tree(want_stats)):
        g = dict(_leaves(got_tree["batch_stats"]))[path]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


def test_fused_backbone_matches_flax():
    """tests/test_edge_train_kernels.py::test_flax_backbone_fused_train_parity
    for the port: forward values, the EMA update, parameter gradients, and
    eval mode ignoring the flag."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 40, 3)).astype(np.float32)
    kw = dict(layer_sizes=(8, 16, 24), k=5, knn_impl="xla")
    fused = JaxDGCNN(**kw, fused_train=True)
    v = fused.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                   train=True, momentum=0.9)
    want, mut = fused.apply(v, jnp.asarray(x), train=True, momentum=0.9,
                            mutable=["batch_stats"])

    def loss(params):
        out = fused.apply({**v, "params": params}, jnp.asarray(x), train=True,
                          momentum=0.9, mutable=["batch_stats"])[0]
        return jnp.sum(jnp.sin(out * 0.3))

    want_grads = jax.grad(loss)(v["params"])
    port = DGCNNBackbone(3, (8, 16, 24), k=5, fused_train=True).train()
    port.load_state_dict(from_flax(to_numpy_tree(v)))
    got = port(torch.from_numpy(x), momentum=0.9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    params = dict(port.named_parameters())
    g = torch.autograd.grad(torch.sum(torch.sin(got * 0.3)),
                            list(params.values()))
    tree = to_flax({**dict(zip(params, g)),
                    **{k: t for k, t in port.state_dict().items()
                       if k.rsplit(".", 1)[-1] in ("mean", "var")}})
    for path, w in _leaves(to_numpy_tree(want_grads)):
        # atol floor: the pre-BN biases' true gradient is 0
        np.testing.assert_allclose(dict(_leaves(tree["params"]))[path], w,
                                   rtol=5e-4, atol=5e-5, err_msg=str(path))
    for path, w in _leaves(to_numpy_tree(mut["batch_stats"])):
        np.testing.assert_allclose(dict(_leaves(tree["batch_stats"]))[path],
                                   w, rtol=1e-5, atol=1e-6, err_msg=str(path))
    # eval mode ignores the flag: the running-statistics path
    e_want = fused.apply(v, jnp.asarray(x), train=False, momentum=0.9)
    port.load_state_dict(from_flax(to_numpy_tree(v)))
    e_got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(e_got.detach().numpy(), np.asarray(e_want),
                               rtol=1e-5, atol=1e-5)


def test_flax_dgcnn_tree_round_trips_through_a_fused_port_model():
    spec = SPECS["dgcnn_fused"]
    _, variables = trained_variables(spec)
    tree = to_numpy_tree(variables)
    port = TorchAlignNet(torch_spec(spec))
    port.load_state_dict(from_flax(tree))
    back = to_flax(port.state_dict())
    for collection in ("params", "batch_stats"):
        want = dict(_leaves(tree[collection]))
        got = dict(_leaves(back[collection]))
        assert want.keys() == got.keys()
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])


def test_stable_max_grad_pools_route_to_the_first_argmax():
    """``stable_max_grad`` changes the train-mode pools' gradient routing
    only: on exact ties (duplicate points) the whole cotangent goes to the
    first of them, where ``torch.amax`` splits it; values are the same."""
    from alignnet3d_tpu_torch.models.backbones import PointNetBackbone

    x = torch.tensor(np.random.default_rng(8).normal(size=(2, 6, 3)),
                     dtype=torch.float32)
    x = torch.cat([x, x], dim=1)  # every point twice
    outs = []
    for stable in (False, True):
        torch.manual_seed(0)
        bb = PointNetBackbone(3, (4, 8), stable_max_grad=stable).train()
        xs = x.clone().requires_grad_()
        out = bb(xs)
        (g,) = torch.autograd.grad(out.sum(), xs)
        outs.append((out.detach(), g))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    # the duplicates' summed gradient agrees, the split does not
    torch.testing.assert_close(outs[1][1][:, :6] + outs[1][1][:, 6:],
                               outs[0][1][:, :6] + outs[0][1][:, 6:])
    assert not torch.equal(outs[1][1], outs[0][1])
