"""The completion head and its loss in the port against the JAX package on
the CPU (``model.options.completion_points``, ``training.loss.options.
completion_weight``).

- The model: ``pred_pc{1,2}completions`` of shape (B, m, 3) from the
  ``siamese.completion`` head, equal to flax ``AlignNet.apply`` within
  1e-5 (float32, summation order only); with ``completion_points`` 0 no
  head and no keys.
- The losses: ``_sq_chamfer``, ``_completion_loss`` and ``loss_separate``
  with a completion weight, values within rtol 1e-5 / atol 1e-6 and
  gradients within rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad``, as
  tests/test_torch_losses.py holds the other terms; the guard's
  ``ValueError`` without the head.
- Checkpoints: a JAX ``TrainState`` of a completion model read by the port
  and written back leaf for leaf, the head's Adam moments included.
- Serving: the folded forward ignores the head, and a completion run
  trained by the port serves through ``Aligner.from_checkpoint``.
- The three repo configs with the head construct and train one epoch
  through the port's CLI at a small point count.
"""

import dataclasses
import json
import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models import losses as jl
from alignnet3d_tpu.training.trainer import TrainState
from alignnet3d_tpu_torch import checkpoint, cli
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.models import losses as tl
from alignnet3d_tpu_torch.models.alignnet import AlignNet
from alignnet3d_tpu_torch.serving import build_inference_fn
from alignnet3d_tpu_torch.weights import from_flax

torch.set_num_threads(1)

B, M, N = 4, 16, 32
NB = SPEC.num_bins
COMP_SPEC = dataclasses.replace(SPEC, completion_points=M)
TOL = 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
COMP_KEYS = ("pred_pc1completions", "pred_pc2completions")
COMP_CONFIGS = ("SynthCars40kComp", "SynthCars40kCompR4", "SynthCars80kR4Comp")


def _port(variables, spec):
    model = AlignNet(torch_spec(spec))
    model.load_state_dict(from_flax(to_numpy_tree(variables)))
    return model


def _clouds(seed, n=N, b=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def comp_model():
    return trained_variables(COMP_SPEC)


def test_completion_head_shapes_and_default_off(comp_model):
    model, variables = comp_model
    port = _port(variables, COMP_SPEC).eval()
    a, b = _clouds(1, COMP_SPEC.num_points, 6)
    ref = model.apply(variables, jnp.asarray(a), jnp.asarray(b), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b))
    assert got.keys() == ref.keys()
    for key in COMP_KEYS:
        assert got[key].shape == (6, M, 3)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    # the head is off by default: no parameters, no end_points
    off = AlignNet(torch_spec(SPEC)).eval()
    assert not any(k.startswith("siamese.completion")
                   for k in off.state_dict())
    with torch.no_grad():
        out = off(torch.from_numpy(a), torch.from_numpy(b))
    assert not set(COMP_KEYS) & out.keys()
    assert {"siamese.completion.fc1.weight", "siamese.completion.bn1.var",
            "siamese.completion.fc2.bias"} <= port.state_dict().keys()


def _jax_grads(fn, args):
    value, grads = jax.value_and_grad(
        lambda xs: fn(*xs), argnums=0)([jnp.asarray(a) for a in args])
    return np.asarray(value), [np.asarray(g) for g in grads]


def _torch_grads(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    value = fn(*ts)
    grads = torch.autograd.grad(value, ts)
    return value.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("seed", [0, 1])
def test_sq_chamfer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, M, 3)).astype(np.float32)
    target = rng.normal(size=(B, 2 * N, 3)).astype(np.float32)
    want = jax.vmap(lambda p, t: jl._sq_chamfer(p[None], t[None])[0])(
        jnp.asarray(pred), jnp.asarray(target))
    got = tl._sq_chamfer(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE_TOL)
    jv, jg = _jax_grads(lambda p, t: jnp.sum(jl._sq_chamfer(p, t)),
                        (pred, target))
    tv, tg = _torch_grads(lambda p, t: torch.sum(tl._sq_chamfer(p, t)),
                          (pred, target))
    np.testing.assert_allclose(tv, jv, **VALUE_TOL)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    # zero against itself
    np.testing.assert_allclose(
        tl._sq_chamfer(torch.from_numpy(pred), torch.from_numpy(pred)), 0.0,
        atol=1e-5)


def _completion_inputs(seed):
    rng = np.random.default_rng(seed)
    pcs1, pcs2 = _clouds(seed + 10)
    c1, c2 = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
    a1, a2 = (rng.uniform(-np.pi, np.pi, B).astype(np.float32)
              for _ in range(2))
    comp1, comp2 = (rng.normal(size=(B, M, 3)).astype(np.float32)
                    for _ in range(2))
    return pcs1, pcs2, c1, c2, a1, a2, comp1, comp2


@pytest.mark.parametrize("seed", [0, 1])
def test_completion_loss_matches_jax(seed):
    args = _completion_inputs(seed)

    def jax_fn(p1, p2, c1, c2, a1, a2, k1, k2):
        return jl._completion_loss(p1, p2, c1, c2, a1, a2, {
            COMP_KEYS[0]: k1, COMP_KEYS[1]: k2})

    def torch_fn(p1, p2, c1, c2, a1, a2, k1, k2):
        return tl._completion_loss(p1, p2, c1, c2, a1, a2, {
            COMP_KEYS[0]: k1, COMP_KEYS[1]: k2})

    jv, jg = _jax_grads(jax_fn, args)
    tv, tg = _torch_grads(torch_fn, args)
    np.testing.assert_allclose(tv, jv, **VALUE_TOL)
    names = ("pcs1", "pcs2", "c1", "c2", "a1", "a2", "comp1", "comp2")
    for name, g, w in zip(names, tg, jg):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
    # a completion flipped by 180 degrees about z scores the same
    flip = np.asarray([-1.0, -1.0, 1.0], np.float32)
    flipped = (*args[:6], args[6] * flip, args[7] * flip)
    np.testing.assert_allclose(
        float(torch_fn(*map(torch.from_numpy, flipped))), float(tv),
        rtol=1e-5)


LOSS_SPECS = {
    # configs/SynthCars40kComp.json's loss options
    "synthcars40k_comp": dict(accept_inverted_angle=True,
                              composite_translation=True,
                              flip_aware_composite=True,
                              completion_weight=1.0),
    "half_weight_consistency": dict(completion_weight=0.5,
                                    center_consistency_weight=0.2),
}


@pytest.mark.parametrize("name", list(LOSS_SPECS))
def test_loss_separate_with_completion_matches_jax(name):
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    labels = (f(B, N, 3), f(B, N, 3), f(B, 3), f(B, 1) * 2, f(B, 3) * 5,
              f(B, 3) * 5, f(B, 1) * 2, f(B, 1) * 2)
    widths = {"pred_s1_pc1centers": 3, "pred_s1_pc2centers": 3,
              "pred_s2_pc1centers": 3, "pred_s2_pc2centers": 3,
              "pred_pc1angle_logits": 2 * NB, "pred_pc2angle_logits": 2 * NB,
              "pred_translations": 3, "pred_remaining_angle_logits": 2 * NB}
    end_points = {k: f(B, d) * (3.0 if "logits" in k else 1.0)
                  for k, d in widths.items()}
    end_points.update({k: f(B, M, 3) for k in COMP_KEYS})
    kw = dict(loss="separate", num_bins=NB, **LOSS_SPECS[name])

    def jax_loss(ep):
        return jl.get_loss(*[jnp.asarray(a) for a in labels], ep,
                           spec=jl.LossSpec(**kw))

    (want, want_aux), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in end_points.items()})
    ep = {k: torch.tensor(v, requires_grad=True) for k, v in end_points.items()}
    got, got_aux = tl.get_loss(*[torch.from_numpy(a) for a in labels], ep,
                               spec=tl.LossSpec(**kw))
    got_grads = dict(zip(ep, torch.autograd.grad(
        got, list(ep.values()), allow_unused=True, materialize_grads=True)))
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)
    assert got_aux.keys() == want_aux.keys()
    assert "losses_stages/completion_loss" in got_aux
    for key in want_aux:
        np.testing.assert_allclose(got_aux[key].item(), float(want_aux[key]),
                                   **VALUE_TOL, err_msg=key)
    for key in end_points:
        np.testing.assert_allclose(got_grads[key].numpy(),
                                   np.asarray(want_grads[key]), **GRAD_TOL,
                                   err_msg=key)
    # the guard: a completion weight without the head is a config error
    no_head = {k: v for k, v in ep.items() if k not in COMP_KEYS}
    with pytest.raises(ValueError, match="completion_points"):
        tl.get_loss(*[torch.from_numpy(a) for a in labels], no_head,
                    spec=tl.LossSpec(**kw))


def test_completion_train_state_reads_and_writes_leaf_for_leaf(comp_model,
                                                               tmp_path):
    """A JAX TrainState of a completion model after 3 Adam updates: the
    port loads it, the head's weights and moments included, and writes the
    same tree back, which the JAX package restores."""
    model, variables = comp_model
    tx = optax.adam(lambda count: 1e-3 * 0.5 ** count)
    params = variables["params"]
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape), p.dtype), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=opt_state)
    data = fs.to_bytes(state)
    assert "completion" in state.params["siamese"]
    path = str(tmp_path / "model-0.msgpack")
    with open(path, "wb") as f:
        f.write(data)
    port = AlignNet(torch_spec(COMP_SPEC))
    opt = torch.optim.Adam(port.parameters())
    assert checkpoint.load(path, port, opt) == {"step": 3,
                                                "schedule_count": 3}
    head = port.siamese.completion.fc2.weight
    np.testing.assert_array_equal(
        head.detach().numpy(),
        np.asarray(params["siamese"]["completion"]["fc2"]["kernel"]).T)
    np.testing.assert_array_equal(
        opt.state[head]["exp_avg"].numpy(),
        np.asarray(opt_state[0].mu["siamese"]["completion"]["fc2"]
                   ["kernel"]).T)
    back = checkpoint.train_state_tree(port, opt, 3, 3)
    want = to_numpy_tree(fs.msgpack_restore(data))
    flat = dict(_flat(back))
    assert flat.keys() == dict(_flat(want)).keys()
    for key, w in _flat(want):
        np.testing.assert_array_equal(flat[key], w, err_msg=str(key))
    # and the JAX package restores what the port writes
    again = dict(_flat(to_numpy_tree(fs.to_state_dict(
        fs.from_bytes(state, checkpoint.to_bytes(back))))))
    for key, w in _flat(want):
        np.testing.assert_array_equal(again[key], w, err_msg=str(key))


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def test_folded_forward_ignores_the_completion_head(comp_model):
    _, variables = comp_model
    port = _port(variables, COMP_SPEC).eval()
    fn = build_inference_fn(torch_spec(COMP_SPEC), port.state_dict(),
                            device="cpu")
    a, b = (torch.from_numpy(x) for x in _clouds(9, COMP_SPEC.num_points))
    folded = fn(a, b)
    with torch.no_grad():
        unfolded = port(a, b)
    assert not set(COMP_KEYS) & folded.keys()
    for key in folded:
        np.testing.assert_allclose(folded[key].numpy(),
                                   unfolded[key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("comp") / "Comp")
    generate_dataset(base, num_train=8, num_val=4, seed=43, vres=12,
                     hres=120)
    return base


@pytest.mark.parametrize("name", COMP_CONFIGS)
def test_repo_completion_configs_train_through_the_cli(name, dataset,
                                                       tmp_path):
    """Each repo config with the completion head, unmodified but for the
    data, the log directory and its size knobs (64 points, batch 4, one
    epoch), trains through the port's CLI and its run serves through
    ``Aligner.from_checkpoint``."""
    with open(f"configs/{name}.json") as f:
        cfg = json.load(f)
    assert cfg["model"]["options"]["completion_points"] == 256
    assert cfg["training"]["loss"]["options"]["completion_weight"] > 0
    cfg["data"]["basepath"] = dataset
    cfg["logging"] = {"basedir": str(tmp_path / "runs")}
    cfg["training"].update(num_epochs=1, batch_size=4)
    cfg["training"].pop("pretraining", None)
    cfg["model"]["num_points"] = 64
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    trainer = cli.main(["train", "--config", path, "--device", "cpu"])
    assert trainer.model.siamese.completion is not None
    logdir = tmp_path / "runs" / name
    with open(logdir / "train" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    assert all(np.isfinite(r["losses_stages/completion_loss"])
               and r["losses_stages/completion_loss"] > 0 for r in rows)
    with open(logdir / "val" / "eval000000" / "eval.json") as f:
        assert json.load(f)["num"] == 4
    clouds = [np.load(f"{dataset}/pointcloud{k}/{i:08d}.npy")
              for k in (1, 2) for i in range(3)]
    out = Aligner.from_checkpoint(str(logdir / "config.json"),
                                  str(logdir / "model-0.pt"),
                                  device="cpu").align(clouds[:3], clouds[3:])
    assert out["transforms"].shape == (3, 4, 4)
    assert np.isfinite(out["transforms"]).all()
    assert os.path.isfile(logdir / "model.ckpt.pt")
