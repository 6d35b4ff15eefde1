"""The port's losses, schedules, optimizer steps and input jitter against
the JAX package on the CPU: loss values, every ``aux`` term and the
gradients with respect to the end_points (against ``jax.grad``), the LR
and BN-momentum schedules at the step boundaries of tests/test_training.py,
and the Adam and momentum updates against optax on identical gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alignnet3d_tpu.config import config_from_dict as jax_config
from alignnet3d_tpu.models import losses as jl
from alignnet3d_tpu.ops import angle_codec as jac
from alignnet3d_tpu.training import schedules as js
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.models import losses as tl
from alignnet3d_tpu_torch.ops import angle_codec as tac
from alignnet3d_tpu_torch.training import schedules as ts

torch.set_num_threads(1)

B, NB, N = 6, 8, 32
SPECS = {
    # SynthCars40kDGCNN(FusedR4): accept_inverted_angle, reference_max,
    # composite translation with the flip-aware rebase
    "synthcars40k_dgcnn": dict(accept_inverted_angle=True,
                               composite_translation=True,
                               flip_aware_composite=True),
    "reference_defaults": dict(),
    "min_soft_consistency": dict(accept_inverted_angle=True,
                                 inverted_angle_mode="min",
                                 soft_angle_classes=True,
                                 center_consistency_weight=0.5),
    "world_consistency": dict(center_consistency_weight=0.3,
                              center_consistency_frame="world"),
}
END_POINTS = {
    "pred_s1_pc1centers": 3, "pred_s1_pc2centers": 3,
    "pred_s2_pc1centers": 3, "pred_s2_pc2centers": 3,
    "pred_pc1angle_logits": 2 * NB, "pred_pc2angle_logits": 2 * NB,
    "pred_translations": 3, "pred_remaining_angle_logits": 2 * NB,
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    labels = (f(B, N, 3), f(B, N, 3), f(B, 3), f(B, 1) * 2, f(B, 3) * 5,
              f(B, 3) * 5, f(B, 1) * 2, f(B, 1) * 2)
    end_points = {k: f(B, d) * (3.0 if "logits" in k else 1.0)
                  for k, d in END_POINTS.items()}
    return labels, end_points


def _jax_loss_and_grads(labels, end_points, spec):
    def loss(ep):
        value, aux = jl.get_loss(*[jnp.asarray(a) for a in labels], ep,
                                 spec=spec)
        return value, aux

    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in end_points.items()})
    return value, aux, grads


def _torch_loss_and_grads(labels, end_points, spec):
    ep = {k: torch.tensor(v, requires_grad=True) for k, v in end_points.items()}
    value, aux = tl.get_loss(*[torch.from_numpy(a) for a in labels], ep,
                             spec=spec)
    grads = torch.autograd.grad(value, list(ep.values()), allow_unused=True,
                                materialize_grads=True)
    return value, aux, dict(zip(ep, grads))


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_separate_matches_jax(name, seed):
    kw = dict(loss="separate", num_bins=NB, **SPECS[name])
    labels, end_points = _inputs(seed)
    want, want_aux, want_grads = _jax_loss_and_grads(
        labels, end_points, jl.LossSpec(**kw))
    got, got_aux, got_grads = _torch_loss_and_grads(
        labels, end_points, tl.LossSpec(**kw))
    # f32 on both sides, the same formulas: summation order and the
    # transcendental functions' last bits
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert got_aux.keys() == want_aux.keys()
    for key in want_aux:
        np.testing.assert_allclose(got_aux[key].item(), float(want_aux[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in END_POINTS:
        np.testing.assert_allclose(got_grads[key].numpy(),
                                   np.asarray(want_grads[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_loss_p2p_matches_jax():
    labels, end_points = _inputs(2)
    want, want_aux, want_grads = _jax_loss_and_grads(
        labels, end_points, jl.LossSpec(loss="p2p", num_bins=NB))
    got, got_aux, got_grads = _torch_loss_and_grads(
        labels, end_points, tl.LossSpec(loss="p2p", num_bins=NB))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_aux["losses/p2p"].item(),
                               float(want_aux["losses/p2p"]), rtol=1e-5)
    for key in END_POINTS:
        np.testing.assert_allclose(got_grads[key].numpy(),
                                   np.asarray(want_grads[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_loss_spec_from_config_and_checks():
    d = {"training": {"loss": {"options": {
        "composite_translation": True, "flip_aware_composite": True,
        "center_consistency_weight": 0.2}}},
        "model": {"angles": {"accept_inverted_angle": True}}}
    assert dataclasses.asdict(tl.LossSpec.from_config(config_from_dict(d))) \
        == dataclasses.asdict(jl.LossSpec.from_config(jax_config(d)))
    with pytest.raises(ValueError, match="composite_translation"):
        tl.LossSpec(flip_aware_composite=True)
    with pytest.raises(ValueError, match="center_consistency_frame"):
        tl.LossSpec(center_consistency_frame="body")
    labels, end_points = _inputs(3)
    ep = {k: torch.from_numpy(v) for k, v in end_points.items()}
    # a completion weight without the model's completion head
    with pytest.raises(ValueError, match="completion_points"):
        tl.loss_separate(*[torch.from_numpy(a) for a in labels], ep,
                         tl.LossSpec(num_bins=NB, completion_weight=1.0))


def test_soft_targets_and_angle_diff_match_jax():
    rng = np.random.default_rng(4)
    deg = rng.uniform(0, 360, 16).astype(np.float32)
    np.testing.assert_allclose(
        tac.soft_angle_targets(torch.from_numpy(deg), 12, 5.0).numpy(),
        np.asarray(jac.soft_angle_targets(jnp.asarray(deg), 12, 5.0)),
        rtol=1e-5, atol=1e-6)
    a, b = (rng.uniform(-7, 7, 32).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tac.jax_angle_diff(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jac.jax_angle_diff(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


def _sched_cfg(per="epoch", step=30):
    return {"training": {
        "batch_size": 64, "learning_rate": 0.01,
        "lr_extension": {"mode": "decay", "per": per, "step": step,
                         "rate": 0.5},
        "bn_extension": {"mode": "decay", "per": per, "step": step,
                         "rate": 0.5, "init": 0.5, "clip": 0.99}}}


@pytest.mark.parametrize("per,step,nbpe,steps", [
    ("epoch", 30, 100, [0, 1, 2999, 3000, 3001, 5999, 6000, 10 ** 6]),
    ("step", 1000, 1, [0, 15, 16, 31, 32, 1000]),
])
def test_schedules_match_jax_at_the_boundaries(per, step, nbpe, steps):
    d = _sched_cfg(per, step)
    tcfg, jcfg = config_from_dict(d), jax_config(d)
    for s in steps:
        # float32 in the same order on both sides: bit-equal
        assert ts.learning_rate(s, tcfg, nbpe) == float(
            js.learning_rate(jnp.asarray(s), jcfg, nbpe)), s
        assert ts.bn_decay(s, tcfg, nbpe) == float(
            js.bn_decay(jnp.asarray(s), jcfg, nbpe)), s


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_optimizer_steps_match_optax(name):
    """Three updates on identical gradients, the LR read from the schedule
    at the count before each update (as optax's schedule reads it)."""
    d = _sched_cfg("step", 128)  # a decay after every 2 steps at bs 64
    tcfg = config_from_dict(d)
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]

    def lr_fn(count):
        return js.learning_rate(jnp.asarray(count), jax_config(d), 1)

    tx = (optax.adam(learning_rate=lr_fn) if name == "adam"
          else optax.sgd(learning_rate=lr_fn, momentum=0.9))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in ("w", "b")]
    opt = (torch.optim.Adam(tp, lr=0.0) if name == "adam"
           else torch.optim.SGD(tp, lr=0.0, momentum=0.9))
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = ts.learning_rate(step, tcfg, 1)
        opt.step()
        for p, k in zip(tp, ("w", "b")):
            # the same update, rounded in another order
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_jitter_distribution():
    """sigma 0.01, clipped at +-0.05, zero mean: checked on 10^6 draws."""
    from alignnet3d_tpu_torch.training.trainer import Trainer

    trainer = Trainer.__new__(Trainer)
    trainer.device = torch.device("cpu")
    trainer._jitter_gen = torch.Generator().manual_seed(0)
    noise = trainer._jitter(torch.zeros((1000, 1000))).numpy()
    assert abs(noise.mean()) < 5e-5            # 5 standard errors
    assert abs(noise.std() - 0.01) < 1e-4      # clipping at 5 sigma: ~0
    assert noise.max() <= 0.05 and noise.min() >= -0.05
    # a normal's share beyond 3 sigma, 0.27%, kept by the clip at 5 sigma
    assert abs((np.abs(noise) > 0.03).mean() - 0.0027) < 3e-4
