"""The residual-alignment task (``data.residual_task``) of the port against
the JAX package on the CPU: ``invert_rigid_batch``, ``params_from_config``
and ``apply_residual_task`` bit-equal on the same batch and seed; the
``Trainer``'s batches equal batch for batch; and one fine-tune epoch of
the two-stage refiner recipe (``configs/SynthCars80kRefiner.json``:
``pretraining.model`` plus ``residual_task``) from one ``.msgpack`` run
gives the JAX ``Trainer``'s eval predictions.

Tolerances: the numpy task exactly (the same float64 operations in the
same order); eval predictions within 1e-4 (tests/test_torch_eval_stack.py:
the float32 forward's summation order), after two momentum-SGD steps with
no jitter and no dropout (jitter and dropout draw from each package's own
generator).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alignnet3d_tpu.training.trainer as jax_trainer_module
from alignnet3d_tpu import geometry as jax_geometry
from alignnet3d_tpu.config import config_from_dict as jax_config_from_dict
from alignnet3d_tpu.data import residual as jax_residual
from alignnet3d_tpu.training.trainer import Trainer as JaxTrainer
from alignnet3d_tpu_torch import checkpoint, geometry
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data import residual
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
MODEL = {
    "backbone": "pointnet", "num_points": 32,
    "options": {
        "s1transformer": [[8, 16], [[16], 1.0]],
        "s2transformer": [[8, 16], [[16], 1.0]],
        "embedding": [8, 16],
        "remaining_transform_prediction": [[16], 1.0],
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}
PREDS = ("pred_translations", "pred_angles", "pred_s1_pc1centers",
         "pred_s1_pc2centers", "pred_s2_pc1centers", "pred_s2_pc2centers",
         "pred_s2_pc1angles", "pred_s2_pc2angles")


def _batch(seed, b=6, n=32, empty=(2,)):
    """A provider-shaped 8-tuple with consistent labels; the clouds in
    ``empty`` are all zero, as the provider leaves an empty cloud."""
    rng = np.random.default_rng(seed)
    pc1 = rng.normal(size=(b, n, 3)).astype(np.float32)
    pc1[list(empty)] = 0.0
    c1 = pc1.mean(axis=1)
    t = (rng.normal(size=(b, 3)) * 2).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    a1 = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    pc2 = rng.normal(size=(b, n, 3)).astype(np.float32)
    return (pc1, pc2, t, a.reshape(b, 1), c1, pc2.mean(axis=1),
            a1.reshape(b, 1), (a1 + a).reshape(b, 1))


def test_invert_rigid_batch_is_the_jax_packages():
    rng = np.random.default_rng(3)
    M = geometry.get_mat_angle_batch(rng.normal(size=(5, 3)),
                                     rng.uniform(-3, 3, 5),
                                     rng.normal(size=(5, 3)))
    got = geometry.invert_rigid_batch(M)
    np.testing.assert_array_equal(got, jax_geometry.invert_rigid_batch(M))
    np.testing.assert_allclose(np.einsum("nij,njk->nik", got, M),
                               np.tile(np.eye(4), (5, 1, 1)), atol=1e-12)


CONFIGS = {
    "absent": {},
    "disabled": {"residual_task": {"enabled": False}},
    "defaults": {"residual_task": {"enabled": True}},
    "overrides": {"residual_task": {"enabled": True, "xy_std": 0.2,
                                    "flip_prob": 0.5}},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_from_config_is_the_jax_packages(name):
    d = {"data": CONFIGS[name]}
    assert residual.params_from_config(config_from_dict(d)) == \
        jax_residual.params_from_config(jax_config_from_dict(d))


PARAMS = {
    "defaults": residual.DEFAULTS,
    "tails": dict(residual.DEFAULTS, outlier_prob=0.6, flip_prob=0.5),
    "no tails": dict(residual.DEFAULTS, outlier_prob=0.0, flip_prob=0.0),
}


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_residual_task_is_the_jax_packages(name, seed):
    batch = _batch(seed)
    got = residual.apply_residual_task(
        batch, np.random.default_rng(seed + 10), **PARAMS[name])
    want = jax_residual.apply_residual_task(
        batch, np.random.default_rng(seed + 10), **PARAMS[name])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    assert got[1] is batch[1] and got[5] is batch[5] and got[7] is batch[7]
    assert not got[0][2].any()  # the empty cloud stays empty


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("residual") / "src")
    generate_dataset(base, num_train=8, num_val=4, seed=9, vres=16, hres=180)
    return base


def _config(base, logdir, **extra):
    d = {
        "data": {"basepath": base, "residual_task": {"enabled": True}},
        "logging": {"basedir": os.path.dirname(logdir), "logdir": logdir},
        "model": MODEL,
        "training": {"batch_size": 4, "num_epochs": 1, "learning_rate": 1e-3,
                     "optimizer": {"optimizer": "momentum", "momentum": 0.9}},
        "evaluation": {"accept_inverted_angle": True, "scale_residuals": True,
                       "resolve_flips": True},
    }
    for key, value in extra.items():
        d[key].update(value)
    return d


def _workspaces(source, root):
    out = {}
    for name in ("jax", "port"):
        base = str(root / name / "data")
        shutil.copytree(source, base)
        out[name] = (base, str(root / name / "runs" / "refiner"))
    return out


def _jax_trainer(d):
    return JaxTrainer(jax_config_from_dict(d), seed=0, use_mesh=False)


def test_trainer_batches_are_the_jax_packages(source, tmp_path):
    ws = _workspaces(source, tmp_path)
    port = Trainer(config_from_dict(_config(*ws["port"])), seed=0,
                   device="cpu")
    jtr = _jax_trainer(_config(*ws["jax"]))
    assert port._residual_params == jtr._residual_params
    for tags, idxs in (((1, 0), port.train_indices[:4]),
                       ((2,), port.val_indices)):
        rngs = port._epoch_rng(*tags), jtr._epoch_rng(*tags)
        for _ in range(2):  # the stream advances alike
            got, want = (tr._make_batch(idxs, rng=r)
                         for tr, r in zip((port, jtr), rngs))
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=str(i))


# the JAX Trainer's device-side jitter: zero here, as the port's _jitter
# is made the identity (tests/test_torch_checkpoint.py)
class _Delegate:
    def __init__(self, target, **overrides):
        self._target, self._overrides = target, overrides

    def __getattr__(self, name):
        if name in self._overrides:
            return self._overrides[name]
        return getattr(self._target, name)


_NO_JITTER_JAX = _Delegate(jax, random=_Delegate(
    jax.random, normal=lambda key, shape, *a, **k: jnp.zeros(shape)))


def test_refiner_epoch_matches_jax(source, tmp_path):
    """The refiner recipe: a coarse run's ``.msgpack`` (the port's seeded
    init, written in the JAX layout) as ``pretraining.model``, one epoch
    on the residual task; the 'pretr' eval and the epoch's eval give the
    JAX ``Trainer``'s predictions."""
    ws = _workspaces(source, tmp_path)
    coarse = str(tmp_path / "coarse" / "model-9")
    first = Trainer(config_from_dict(_config(*ws["port"])), seed=3,
                    device="cpu")
    first.init_state()
    checkpoint.save(coarse + ".msgpack", first.model, first.optimizer, 0, 0)

    extra = {"training": {"pretraining": {"model": coarse}}}
    jtr = _jax_trainer(_config(*ws["jax"], **extra))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "jax", _NO_JITTER_JAX)
        jtr.train()
    port = Trainer(config_from_dict(_config(*ws["port"], **extra)), seed=0,
                   device="cpu")
    port._jitter = lambda pcs: pcs
    port.train()
    assert port.step == port.schedule_count == 2
    for epoch in ("0pretr", "000000"):
        for key in PREDS:
            got = np.load(f"{ws['port'][1]}/val/eval{epoch}/{key}.npy")
            want = np.load(f"{ws['jax'][1]}/val/eval{epoch}/{key}.npy")
            if key.endswith("angles"):
                got = np.mod(got - want + np.pi, 2 * np.pi) - np.pi
                want = np.zeros_like(want)
            np.testing.assert_allclose(got, want, atol=TOL,
                                       err_msg=f"{epoch} {key}")


def test_network_refine_and_residual_task_exclude_each_other(source,
                                                             tmp_path):
    base, logdir = _workspaces(source, tmp_path)["port"]
    trainer = Trainer(config_from_dict(_config(
        base, logdir, evaluation={"network_refine": {"enabled": True}})),
        seed=0, device="cpu")
    trainer.init_state()
    n = len(trainer.val_indices)
    P = {"pred_translations": np.zeros((n, 3), np.float32),
         "pred_angles": np.zeros((n, 1), np.float32),
         "pred_s2_pc1centers": np.zeros((n, 3), np.float32)}
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainer._network_refine_pass(P, trainer.val_indices, 4, 1.0,
                                     trainer.cfg.evaluation.network_refine)


def test_the_refiner_config_builds_a_trainer(source):
    """``configs/SynthCars80kRefiner.json`` is no longer refused, and its
    task parameters are the JAX package's."""
    with open(os.path.join(ROOT, "configs", "SynthCars80kRefiner.json")) as f:
        d = json.load(f)
    d["data"]["basepath"] = source
    d["logging"]["logdir"] = "unused"
    trainer = Trainer(config_from_dict(d), device="cpu")
    assert trainer._residual_params == jax_residual.params_from_config(
        jax_config_from_dict(d))
    assert trainer.cfg.training.pretraining.model.endswith("model-209")
