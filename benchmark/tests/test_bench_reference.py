"""The plain reference (and the frozen inputs) held to the port's CPU path
at small sizes: scenes, weights layout, resampling, batch draw, forward,
flips, ICP from perturbed truth and one training step."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import train as train_driver
from benchmark.inputs import scenes, weights
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train


def _config(name):
    return json.loads((harness.BENCH_DIR / "configs" /
                       f"{name}.json").read_text())


def _spec(conf):
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec

    return ModelSpec.from_config(config_from_dict(
        {k: conf[k] for k in ("model", "training", "evaluation", "tpu")}))


@pytest.mark.parametrize("seed,rays", [(0, (16, 360)), (7, (16, 360)),
                                       (2 ** 40 + 3, (64, 4500))])
def test_frozen_scenes_are_the_ports(seed, rays):
    from alignnet3d_tpu_torch.data.synthetic import SyntheticBoxScene

    c1, c2, lab = scenes.scene(seed, *rays)
    port = SyntheticBoxScene(seed, vres=rays[0], hres=rays[1])
    port.generate_pointcloud()
    assert np.array_equal(c1, port.pointclouds[0])
    assert np.array_equal(c2, port.pointclouds[1])
    assert np.allclose(lab["translation"], port.transform.translation)
    assert lab["rel_angle"] == port.transform.rel_angle


@pytest.mark.parametrize("config", ["pointnet-synthcars",
                                    "dgcnn-synthcars40k"])
def test_weights_layout_is_the_ports(config):
    from alignnet3d_tpu_torch.models.alignnet import AlignNet

    conf = _config(config)
    port = AlignNet(_spec(conf)).state_dict()
    ours = weights.seeded(conf["model"], 5, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in port.items()}


def test_resample_replay_is_the_aligners():
    from alignnet3d_tpu_torch.api import Aligner

    conf = _config("pointnet-synthcars")
    al = Aligner(_spec(conf), weights.seeded(conf["model"], 1, "cpu"),
                 seed=99, device="cpu")
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32)
              for n in (5, 700, 3000)]
    replay = ref_serve.Replay(99, 512, 128)
    for _ in range(2):
        assert np.array_equal(al._resample(clouds), replay._resample(clouds))


def test_batch_draw_is_the_native_assemblers():
    from alignnet3d_tpu_torch.data.native_loader import resample_gather_plain

    rng = np.random.default_rng(1)
    counts = np.asarray([9, 1, 4000, 77], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    points = rng.normal(size=(int(counts.sum()), 3)).astype(np.float32)
    rows = np.asarray([2, 0, 3, 1, 2], np.int64)
    seed = int(rng.integers(0, 2 ** 63))
    assert np.array_equal(
        ref_train.resample_rows(points, offsets, counts, rows, 64, seed),
        resample_gather_plain(points, offsets, counts, rows, 64, seed))


def _clouds(n, b, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n, 3, generator=g) * 1.5 + 6.0,
            torch.randn(b, n, 3, generator=g) * 1.5 + 6.0)


@pytest.mark.parametrize("config", ["pointnet-synthcars",
                                    "dgcnn-synthcars40k"])
def test_forward_is_the_folded_forward(config):
    from alignnet3d_tpu_torch.serving import build_inference_fn

    conf = _config(config)
    conf["model"]["num_points"] = 64
    sd = weights.seeded(conf["model"], 3, "cpu")
    a, b = _clouds(64, 3, 0)
    port = build_inference_fn(_spec(conf), sd, device="cpu")(a, b)
    ref = ref_model.Model(conf["model"], sd).forward(a, b)
    for key, value in port.items():
        assert torch.allclose(value, ref[key], atol=1e-4, rtol=1e-4), key


def test_flips_are_the_ports():
    from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu_torch.serving import build_inference_fn

    conf = _config("pointnet-synthcars")
    conf["model"]["num_points"] = 64
    sd = weights.seeded(conf["model"], 4, "cpu")
    a, b = _clouds(64, 6, 1)
    out = build_inference_fn(_spec(conf), sd, device="cpu")(a, b)
    dec = decode_pair_outputs({k: v.numpy() for k, v in out.items()},
                              a.numpy(), b.numpy(), 50, 1.0,
                              resolve_flips=True, device="cpu")
    t, ang, c, margins = ref_serve.forward_decode(
        ref_model.Model(conf["model"], sd), a.numpy(), b.numpy(), 1.0, True,
        "cpu")
    ok = (margins["logit"] > 1e-3) & (margins["flip"] > 1e-4)
    assert ok.sum() >= 4
    gap = np.abs((dec.angles - ang + np.pi) % (2 * np.pi) - np.pi)
    assert gap[ok].max() < 1e-4
    assert np.abs(dec.translations - t).max() < 1e-4


def test_icp_from_perturbed_truth_is_the_ports():
    from alignnet3d_tpu_torch.icp.p2point import icp_p2point_batch

    n = 2048
    src = np.zeros((3, n, 3), np.float32)
    dst = np.zeros((3, n, 3), np.float32)
    sm, dm = np.zeros((3, n), bool), np.zeros((3, n), bool)
    init, truth = [], []
    for i, seed in enumerate((11, 12, 13)):
        c1, c2, lab = scenes.scene(seed, 32, 720)
        c1, c2 = c1[:n], c2[:n]
        src[i, :len(c1)], sm[i, :len(c1)] = c1, True
        dst[i, :len(c2)], dm[i, :len(c2)] = c2, True
        true = ref_serve.mat_angle(lab["translation"][None],
                                   np.asarray([lab["rel_angle"]]),
                                   lab["start_position"][None])[0]
        truth.append(true)
        init.append(ref_serve.mat_angle(lab["translation"][None] + 0.05,
                                        np.asarray([lab["rel_angle"] + 0.03]),
                                        lab["start_position"][None])[0])
    init = np.stack(init)
    port, _, _ = icp_p2point_batch(src, sm, dst, dm, init, radius=0.1,
                                   its=30, device="cpu")
    ref = ref_serve.icp(src, sm, dst, dm, init, 0.1, 30, "cpu")
    assert np.abs(port - ref).max() < 1e-5
    truth = np.stack(truth)[:, :3, 3]
    err = np.linalg.norm(ref[:, :3, 3] - truth, axis=1)
    assert (err < np.linalg.norm(init[:, :3, 3] - truth, axis=1)).all()


@pytest.mark.parametrize("config", ["dgcnn-synthcars40k",
                                    "pointnet-synthcars"])
def test_one_training_step_is_the_trainers(config, tmp_path):
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.training.trainer import Trainer

    conf = copy.deepcopy(_config(config))
    conf.update(train_pairs=8, val_pairs=2)
    conf["training"]["batch_size"] = 4
    conf["model"]["num_points"] = 32
    items = [scenes.scene(s, 16, 180) for s in range(40)]
    items = [it for it in items if min(len(it[0]), len(it[1])) >= 5][:10]
    scenes.write_dataset(str(tmp_path / "data"), items, 8)
    sd = weights.seeded(conf["model"], 6, "cpu")
    trainer = Trainer(config_from_dict(train_driver.port_config(
        conf, str(tmp_path / "data"), str(tmp_path / "run"))), seed=17,
        device="cpu")
    trainer.init_state()
    trainer.model.load_state_dict(sd)
    batch_idx = np.asarray([3, 0, 7, 5])
    batch = trainer.dataset.sample_batch(batch_idx, 32,
                                         np.random.default_rng(8))
    loss = float(trainer.train_step(batch)["losses/loss"])
    grads = {k: trainer.optimizer.state[p]["exp_avg"] / 0.1
             for k, p in trainer.model.named_parameters()}
    losses, ref_grads, _ = ref_train.first_steps(
        conf, sd, items, [batch_idx], np.random.default_rng(8), 17, "cpu",
        steps=1)
    assert abs(loss - losses[0]) / abs(losses[0]) < 1e-5
    med = np.median([float(g.norm()) for g in ref_grads.values()])
    for k, g in ref_grads.items():
        assert float((grads[k] - g).norm()) <= 1e-2 * max(float(g.norm()),
                                                          med), k
