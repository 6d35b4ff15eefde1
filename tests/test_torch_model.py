"""The port's unfolded AlignNet against flax ``AlignNet.apply``: every eval
end_point, and the train-mode batch statistics with their EMA update."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models.alignnet import AlignNet
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.models.batchnorm import EmaBatchNorm
from alignnet3d_tpu_torch.weights import from_flax, to_flax

# float32 on the CPU in both packages: the gap is summation order only
TOL = 1e-5


def _port(variables, spec=SPEC):
    model = TorchAlignNet(torch_spec(spec))
    model.load_state_dict(from_flax(to_numpy_tree(variables)))
    return model


def test_eval_end_points_match_flax():
    model, variables = trained_variables()
    port = _port(variables).eval()
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, SPEC.num_points, 3)).astype(np.float32)
    b = rng.normal(size=(6, SPEC.num_points, 3)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(a), jnp.asarray(b), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_train_mode_batch_stats_and_ema_match_flax():
    # dropout off (keep 1.0): the dropped units would differ between the
    # packages' RNGs and, through the s2 yaw, move the embedding's stats
    spec = dataclasses.replace(SPEC, s1_dropout_keep=1.0, s2_dropout_keep=1.0,
                               remaining_dropout_keep=1.0)
    model, variables = trained_variables(spec)
    port = _port(variables, spec).train()
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, spec.num_points, 3)).astype(np.float32)
    b = rng.normal(size=(4, spec.num_points, 3)).astype(np.float32)
    ref, mut = model.apply(variables, jnp.asarray(a), jnp.asarray(b),
                           train=True, momentum=0.7, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
    got = port(torch.from_numpy(a), torch.from_numpy(b), momentum=0.7)
    # the heads' train-mode BN normalises 8 rows by their own small-sample
    # std, which amplifies the summation-order gap of its inputs ~10x
    for key in ref:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    ref_stats = to_numpy_tree(mut["batch_stats"])
    got_stats = to_flax(port.state_dict())["batch_stats"]

    def walk(r, g, path=()):
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], g[k], path + (k,))
            else:
                np.testing.assert_allclose(g[k], r[k], rtol=TOL, atol=TOL,
                                           err_msg=str(path + (k,)))

    walk(ref_stats, got_stats)


def test_batchnorm_train_and_eval():
    bn = EmaBatchNorm(3)
    x = torch.tensor([[[1.0, 2.0, 3.0]], [[3.0, 6.0, 9.0]]])
    bn.train()
    y = bn(x, momentum=0.5)
    mean = torch.tensor([2.0, 4.0, 6.0])
    var = torch.tensor([1.0, 4.0, 9.0])
    torch.testing.assert_close(bn.mean, 0.5 * mean)
    torch.testing.assert_close(bn.var, 0.5 + 0.5 * var)
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-3))
    bn.eval()
    torch.testing.assert_close(
        bn(x), (x - bn.mean) / torch.sqrt(bn.var + 1e-3))


def test_dgcnn_backbone_not_ported():
    """``dgcnn_fused_train`` is ported: a train-mode AlignNet takes the
    fused edge stage (its twin on the CPU) in all three backbones and gives
    the unfused model's end_points, parameter gradients and BN statistics
    from the same weights (no exact ties in these inputs, so the two max
    routings agree)."""
    spec = dataclasses.replace(torch_spec(SPEC), backbone="dgcnn",
                               s1_backbone=(16, 32, 32),
                               s2_backbone=(16, 32, 32),
                               embedding=(16, 32, 64),
                               s1_dropout_keep=1.0, s2_dropout_keep=1.0,
                               remaining_dropout_keep=1.0)
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.normal(size=(2, spec.num_points, 3))
                             .astype(np.float32)) for _ in range(2))
    results = []
    for fused in (False, True):
        torch.manual_seed(0)
        model = TorchAlignNet(dataclasses.replace(
            spec, dgcnn_fused_train=fused)).train()
        out = model(a, b, momentum=0.7)
        loss = sum(torch.sum(torch.sin(v)) for v in out.values())
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((out, grads, model.state_dict()))
    (out_n, g_n, s_n), (out_f, g_f, s_f) = results
    for key in out_n:
        torch.testing.assert_close(out_f[key], out_n[key], rtol=1e-4,
                                   atol=1e-4)
    # relative L2 per tensor: the two paths round differently, which can
    # move a near-tied max over the points and one gradient entry with it.
    # A bias that a BN follows has true gradient 0 (the BN absorbs it):
    # both sides hold ~1e-5 of f32 noise there, so the floor of 1.
    for gf, gn in zip(g_f, g_n):
        assert float((gf - gn).norm()) <= 1e-3 * max(float(gn.norm()), 1.0)
    assert s_f.keys() == s_n.keys()
    for key in s_n:
        torch.testing.assert_close(s_f[key], s_n[key], rtol=1e-5, atol=1e-5)


def test_model_spec_from_config_reads_the_jax_keys():
    from alignnet3d_tpu.config import config_from_dict
    from alignnet3d_tpu.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec as TorchModelSpec

    cfg = config_from_dict({})
    assert dataclasses.asdict(TorchModelSpec.from_config(cfg)) == \
        dataclasses.asdict(ModelSpec.from_config(cfg))
