"""Data-parallel training in the port: two gloo processes on the CPU.

- One training step: two processes, each holding half of a global batch,
  end with the loss, every aux scalar, the parameters and the BN running
  statistics of one process's step on that global batch
  (tests/test_sharding_equivalence.py's tolerances: loss rel 1e-5,
  parameters rtol 2e-4 / atol 2e-5), for the PointNet with the 'separate'
  loss on a batch whose process-0 theta / theta + pi picks differ from the
  global batch's, the PointNet with the 'p2p' loss, and the DGCNN through
  the fused edge stage's plain version. The step is momentum SGD (its first
  step is plain SGD), with dropout and jitter on; the one-process step is
  held to the JAX package by tests/test_torch_train_step.py.
- The CLI: a two-process ``train`` epoch writes what a one-process run
  writes (process 1 only its log under ``proc1/``), the processes end with
  bit-equal parameters, a two-process ``eval_only`` predicts within 1e-5 of
  a one-process eval of the same checkpoint, and a second ``train``
  resumes from the rolling checkpoint.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.models import losses as tl
from alignnet3d_tpu_torch.parallel import dryrun
from alignnet3d_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

POINTNET = {
    "backbone": "pointnet", "num_points": 32,
    "options": {
        "s1transformer": [[8, 16], [[16], 0.7]],
        "s2transformer": [[8, 16], [[16], 0.7]],
        "embedding": [8, 32],
        "remaining_transform_prediction": [[16], 0.7],
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}
DGCNN = {
    "backbone": "dgcnn", "num_points": 24,
    "options": {
        "s1transformer": [[8, 16, 16], [[16], 0.7]],
        "s2transformer": [[8, 16, 16], [[16], 0.7]],
        "embedding": [8, 16, 16],
        "remaining_transform_prediction": [[16], 0.7],
        "dgcnn_fused_train": True, "dgcnn_knn_impl": "xla",
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}
# (model, loss, seed of the global batch); seed 1 gives process 0 rows
# whose theta / theta + pi picks differ from the global batch's
CASES = {
    "pointnet_separate": (POINTNET, "separate", 1),
    "pointnet_p2p": (POINTNET, "p2p", 0),
    "dgcnn_fused": (DGCNN, "separate", 0),
}
GLOBAL_BATCH, PROCS = 8, 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dp_data"))
    generate_dataset(base, num_train=16, num_val=6, seed=4, vres=16,
                     hres=180)
    return base


def _cfg_dict(dataset, logdir, model, loss="separate", **training):
    return {
        "data": {"basepath": dataset},
        # through the CLI the run of <name>.json logs to <basedir>/<name>
        "logging": {"basedir": os.path.dirname(logdir),
                    "logdir": str(logdir)},
        "model": model,
        "training": {"batch_size": GLOBAL_BATCH, "num_epochs": 1,
                     "optimizer": {"optimizer": "momentum", "momentum": 0.9},
                     "loss": {"loss": loss, "options": {
                         "composite_translation": True,
                         "flip_aware_composite": True}},
                     **training},
        "evaluation": {"accept_inverted_angle": True,
                       "scale_residuals": True, "resolve_flips": True,
                       "save_every_epoch": True},
    }


def _batch(num_points, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    b = GLOBAL_BATCH
    return (f(b, num_points, 3), f(b, num_points, 3) + 1.0, f(b, 3),
            f(b, 1), f(b, 3) * 0.3, f(b, 3) * 0.3 + 1.0, f(b, 1), f(b, 1))


def _step(cfg_dict, batch):
    """One training step of a fresh Trainer: (loss, aux, state_dict)."""
    trainer = Trainer(config_from_dict(cfg_dict), seed=0, device="cpu")
    trainer.init_state()
    metrics = trainer.train_step(batch)
    scalars = {k: float(v) for k, v in metrics.items()}
    return scalars, {k: v.detach().clone()
                     for k, v in trainer.model.state_dict().items()}


def _step_worker(rank, rdzv, cfg_dict, batch, out_dir):
    from alignnet3d_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.maybe_initialize(rdzv, PROCS, rank, backend="gloo")
    local = GLOBAL_BATCH // PROCS
    scalars, state = _step(cfg_dict, tuple(
        a[rank * local:(rank + 1) * local] for a in batch))
    torch.save({"scalars": scalars, "state": state},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _picks(cfg_dict, batch):
    """The theta / theta + pi pick of each of the three angle losses that
    one process makes on ``batch`` (its train-mode forward, its means)."""
    trainer = Trainer(config_from_dict(cfg_dict), seed=0, device="cpu")
    trainer.init_state()
    tb = [torch.from_numpy(a) for a in batch]
    out = trainer.model.train()(tb[0], tb[1], momentum=0.5)
    spec = trainer.loss_spec
    nb, scale = spec.num_bins, np.pi / spec.num_bins
    pred = [tl.logits_to_angle(out[k], nb, residual_scale=scale)
            for k in ("pred_pc1angle_logits", "pred_pc2angle_logits")]
    targets = [("pred_pc1angle_logits", tb[6].reshape(-1)),
               ("pred_pc2angle_logits", tb[7].reshape(-1)),
               ("pred_remaining_angle_logits",
                (tb[7] - tb[6]).reshape(-1) - (pred[1] - pred[0]))]
    return [bool(tl._angle_loss(out[k], t, spec)[0]
                 > tl._angle_loss(out[k], t + np.pi, spec)[0])
            for k, t in targets]


@pytest.mark.parametrize("case", list(CASES))
def test_two_process_step_equals_one_process_step(case, dataset, tmp_path):
    model, loss, seed = CASES[case]
    cfg_dict = _cfg_dict(dataset, tmp_path / "run", model, loss)
    batch = _batch(model["num_points"], seed)
    if case == "pointnet_separate":
        # the design that lets each process pick on its own rows would
        # train another loss on this batch
        assert _picks(cfg_dict, tuple(a[:GLOBAL_BATCH // PROCS]
                                      for a in batch)) \
            != _picks(cfg_dict, batch)
    want_scalars, want_state = _step(cfg_dict, batch)
    mp.spawn(_step_worker, nprocs=PROCS, join=True, args=(
        dryrun.file_rendezvous(str(tmp_path)), cfg_dict, batch,
        str(tmp_path)))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(PROCS)]
    for r in ranks[1:]:  # every process ends with the same state
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
        assert r["scalars"] == ranks[0]["scalars"]
    got_scalars, got_state = ranks[0]["scalars"], ranks[0]["state"]
    assert got_scalars["losses/loss"] == pytest.approx(
        want_scalars["losses/loss"], rel=1e-5)
    for k, v in want_scalars.items():
        assert got_scalars[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert want_state.keys() == got_state.keys()
    moved = 0
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
        moved += k.endswith((".mean", ".var"))
    assert moved > 0  # the BN running statistics are compared too


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_epoch_eval_and_resume_in_two_processes(dataset, tmp_path):
    logdir = tmp_path / "dp"
    cfg_path = tmp_path / "dp.json"
    cfg_path.write_text(json.dumps(_cfg_dict(dataset, logdir, POINTNET)))
    cli = ["--config", str(cfg_path), "--device", "cpu"]
    rdzv = lambda: dryrun.file_rendezvous(str(tmp_path))  # noqa: E731

    results = dryrun.run_workers(PROCS, ["train", *cli], rdzv(),
                                 backend="gloo", timeout=300)
    assert len({r["params"] for r in results}) == 1
    # what a one-process run writes, plus process 1's log
    single = tmp_path / "single"
    Trainer(config_from_dict(_cfg_dict(dataset, single, POINTNET)), seed=0,
            device="cpu").train()
    assert _files(logdir) == sorted(_files(single) + ["proc1/out.log"])
    with open(logdir / "train" / "scalars.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]

    # eval_only of the epoch's checkpoint against one process's
    shutil.copytree(logdir, tmp_path / "dp_copy")
    dryrun.run_workers(PROCS, ["eval_only", "--eval_epoch", "0", *cli],
                       rdzv(), backend="gloo", timeout=300)
    one = Trainer(config_from_dict(_cfg_dict(dataset, tmp_path / "dp_copy",
                                             POINTNET)), seed=0, device="cpu")
    one.train(eval_only=True, eval_epoch=0)
    ev = "val/eval000000"
    for name in ("pred_translations", "pred_angles", "pred_s1_pc1centers",
                 "pred_s2_pc2centers", "pred_s2_pc1angles"):
        np.testing.assert_allclose(
            np.load(logdir / ev / f"{name}.npy"),
            np.load(tmp_path / "dp_copy" / ev / f"{name}.npy"),
            rtol=1e-5, atol=1e-5, err_msg=name)

    # a second train resumes from the rolling checkpoint of epoch 0
    cfg2 = _cfg_dict(dataset, logdir, POINTNET)
    cfg2["training"]["num_epochs"] = 2
    cfg_path.write_text(json.dumps(cfg2))
    results = dryrun.run_workers(PROCS, ["train", *cli], rdzv(),
                                 backend="gloo", timeout=300)
    assert "Continuing training at epoch 1" in results[0]["output"]
    assert len({r["params"] for r in results}) == 1
    with open(logdir / "train" / "scalars.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


def test_network_refine_refuses_two_processes(dataset, tmp_path):
    cfg = _cfg_dict(dataset, tmp_path / "nr", POINTNET)
    cfg["evaluation"]["network_refine"] = {"enabled": True}
    cfg_path = tmp_path / "nr.json"
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="network_refine is single-process"):
        dryrun.run_workers(PROCS, ["train", "--config", str(cfg_path),
                                   "--device", "cpu"],
                           dryrun.file_rendezvous(str(tmp_path)),
                           backend="gloo", timeout=300)


def test_dryrun_multihost_two_processes():
    dryrun.dryrun_multihost(2)
