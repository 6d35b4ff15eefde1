"""The port's ``Trainer`` on the CPU: two epochs on a fixture dataset write
the JAX package's artifacts (checkpoints as ``.pt``), a second ``train()``
resumes from the rolling checkpoint, pretrained weights and eval-only runs
restore, ``tpu.profile`` writes a trace, and a special mode that runs
through the CLI alone raises (the eval-time stack is held to the JAX
package in tests/test_torch_eval_stack.py)."""

import json
import os

import numpy as np
import pytest
import torch

from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.models.losses import LossSpec
from alignnet3d_tpu_torch.training.trainer import Trainer, progress

torch.set_num_threads(1)

TINY = {
    "model": {
        "backbone": "dgcnn", "num_points": 32,
        "options": {
            "s1transformer": [[8, 16, 16], [[16], 0.7]],
            "s2transformer": [[8, 16, 16], [[16], 0.7]],
            "embedding": [8, 16, 16],
            "remaining_transform_prediction": [[16], 0.7],
            "dgcnn_fused_train": True,
        },
        "angles": {"num_bins": 8, "accept_inverted_angle": True},
    },
    "training": {"batch_size": 4, "num_epochs": 2,
                 "loss": {"options": {"composite_translation": True,
                                      "flip_aware_composite": True}}},
    "evaluation": {"accept_inverted_angle": True, "scale_residuals": True,
                   "resolve_flips": True},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("train_data"))
    generate_dataset(base, num_train=9, num_val=6, seed=1, vres=16, hres=180)
    return base


def _cfg(dataset, logdir, **overrides):
    d = json.loads(json.dumps(TINY))
    d["data"] = {"basepath": dataset}
    d["logging"] = {"basedir": str(logdir), "logdir": str(logdir)}
    for path, value in overrides.items():
        node = d
        *keys, last = path.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = value
    return config_from_dict(d)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_two_epochs_write_the_artifacts_and_resume(dataset, tmp_path):
    logdir = tmp_path / "run"
    trainer = Trainer(_cfg(dataset, logdir), seed=0, device="cpu")
    trainer.train()
    assert trainer.step == 4  # 9 // 4 = 2 steps an epoch
    for name in ("model.ckpt.pt", "model-0.pt", "model-1.pt", "config.json"):
        assert (logdir / name).is_file(), name
    assert json.load(open(logdir / "config.json"))["model"]["num_points"] == 32
    train_rows = _rows(logdir / "train" / "scalars.jsonl")
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4]
    aux_tags = {"losses/translation", "losses/angle",
                "losses_stages/stage3_angle_residual_loss"}
    assert {"losses/loss", "hyperparameters/learning_rate",
            "hyperparameters/bn_decay"} | aux_tags <= train_rows[0].keys()
    assert all(np.isfinite(r["losses/loss"]) for r in train_rows)
    for split in ("val", "val_180"):
        rows = _rows(logdir / split / "scalars.jsonl")
        assert [r["step"] for r in rows] == [2, 4]
        assert {"accuracy/t_b_1cm", "accuracy/o_d_1m",
                "accuracy/inlier_rmse", "losses/loss"} <= rows[0].keys()
    for epoch in (0, 1):
        ev = logdir / "val" / f"eval{epoch:06d}"
        for name in ("eval.json", "eval_180.json", "pred_translations.npy",
                     "pred_angles.npy", "pred_s1_pc1centers.npy",
                     "pred_s1_pc2centers.npy", "pred_s2_pc1centers.npy",
                     "pred_s2_pc2centers.npy", "pred_s2_pc1angles.npy",
                     "pred_s2_pc2angles.npy"):
            assert (ev / name).is_file(), (epoch, name)
        assert np.load(ev / "pred_angles.npy").shape == (6, 1)
    ckpt = torch.load(logdir / "model-1.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["model"].keys() == \
        trainer.model.state_dict().keys()

    # a second run resumes at epoch 2 from the rolling checkpoint
    again = Trainer(_cfg(dataset, logdir, **{"training.num_epochs": 3}),
                    seed=0, device="cpu")
    again.train()
    assert again.step == 6 and (logdir / "model-2.pt").is_file()
    assert [r["step"] for r in _rows(logdir / "train" / "scalars.jsonl")] \
        == [1, 2, 3, 4, 5, 6]
    logs = [f for f in os.listdir(logdir) if f.startswith("out")]
    assert any("Continuing training at epoch 2" in open(logdir / f).read()
               for f in logs)


def test_eval_only_and_pretrained_restore(dataset, tmp_path):
    logdir = tmp_path / "first"
    cfg = _cfg(dataset, logdir, **{"training.num_epochs": 1})
    first = Trainer(cfg, seed=0, device="cpu")
    first.train()
    want = np.load(logdir / "val" / "eval000000" / "pred_translations.npy")
    # eval-only from model-0 reproduces the predictions (fixed eval stream)
    ev = Trainer(cfg, seed=0, device="cpu")
    ev.train(eval_only=True, eval_epoch=0)
    np.testing.assert_array_equal(
        np.load(logdir / "val" / "eval000000" / "pred_translations.npy"), want)
    # pretrained weights: everything but the step, then a 'pretr' eval
    pre = Trainer(_cfg(dataset, tmp_path / "second", **{
        "training.num_epochs": 1,
        "training.pretraining.model": str(logdir / "model-0")}),
        seed=0, device="cpu")
    pre.train()
    pretr = tmp_path / "second" / "val" / "eval0pretr"  # 'pretr'.zfill(6)
    np.testing.assert_array_equal(np.load(pretr / "pred_translations.npy"),
                                  want)
    assert pre.step == 2


@pytest.mark.parametrize("path,value", [
    ("evaluation.special", {"mode": "icp"}),
])
def test_unported_config_options_raise(dataset, tmp_path, path, value):
    """'icp' runs the standalone baselines through the CLI, not Trainer."""
    with pytest.raises(NotImplementedError, match=f"{path}.*cli"):
        Trainer(_cfg(dataset, tmp_path, **{path: value}), device="cpu")


@pytest.mark.parametrize("batch_size,steps,name", [
    (2, 2, "train_epoch0_steps1-2.json"),  # 4 steps an epoch
    (4, 3, "train_epoch0_steps1-1.json"),  # 2: the epoch ends first
])
def test_tpu_profile_writes_a_trace(dataset, tmp_path, batch_size, steps,
                                    name):
    """As the JAX package: steps 1 to ``steps`` of epoch 0 (step 0 warms
    up), one trace for the run, here a torch.profiler Chrome trace."""
    prof = tmp_path / "prof"
    trainer = Trainer(_cfg(dataset, tmp_path / "run", **{
        "tpu.profile": {"dir": str(prof), "steps": steps},
        "training.batch_size": batch_size}), seed=0, device="cpu")
    trainer.train()
    assert trainer.profile_traces == [str(prof / name)]
    assert os.listdir(prof) == [name]
    with open(prof / name) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::addmm", "aten::max"} & ops, sorted(ops)[:20]


def test_momentum_optimizer_and_device_argument(dataset, tmp_path):
    cfg = _cfg(dataset, tmp_path, **{
        "training.optimizer": {"optimizer": "momentum", "momentum": 0.9},
        "training.num_epochs": 1})
    with pytest.raises(TypeError):
        Trainer(cfg)  # the device is required
    trainer = Trainer(cfg, seed=2, device="cpu")
    trainer.train()
    assert isinstance(trainer.optimizer, torch.optim.SGD)
    assert LossSpec.from_config(cfg).flip_aware_composite


def test_progress_logs_the_closing_count(caplog):
    import logging

    with caplog.at_level(logging.DEBUG, logger="alignnet3d_tpu_torch"):
        assert list(progress(range(3), desc="x", total=3)) == [0, 1, 2]
    assert "progress x: 3/3" in caplog.text
