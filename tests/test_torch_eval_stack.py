"""The port's eval-time stack against the JAX package on the CPU: stored
predictions refined by a 2-stage gated ICP cascade through
``Trainer.train`` and through the CLI, the gated second network pass
(``_network_refine_pass``) with bridged weights, timing mode, and a whole
train + refine run of a full-stack config.

Tolerances: the refined poses to 1e-4 m / 1e-4 rad (the float32 / float64
pose-algebra gap, tests/test_torch_icp.py); the network pass to 1e-4 (the
float32 forward's summation order, tests/test_torch_slice.py); eval.json
numbers to 1e-4 absolute and relative, with ``mean_time``, a wall time,
left out.
"""

import contextlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu import cli as jax_cli
from alignnet3d_tpu.config import config_from_dict as jax_config_from_dict
from alignnet3d_tpu.data import provider as jp
from alignnet3d_tpu.training.trainer import Trainer as JaxTrainer
from alignnet3d_tpu_torch import cli, tracing
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.training.trainer import Trainer
from alignnet3d_tpu_torch.weights import to_flax

torch.set_num_threads(1)

TOL = 1e-4
PREDS = ("pred_translations", "pred_angles", "pred_s2_pc1centers")
CASCADE = [{"radius": 0.3},
           {"radius": 0.1, "its": 10, "max_dyaw_deg": 1.0, "max_dxy": 0.05}]
MODEL = {
    "backbone": "pointnet", "num_points": 32,
    "options": {
        "s1transformer": [[8, 16], [[16], 0.7]],
        "s2transformer": [[8, 16], [[16], 0.7]],
        "embedding": [8, 16],
        "remaining_transform_prediction": [[16], 0.7],
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("eval_stack") / "src")
    generate_dataset(base, num_train=8, num_val=6, seed=4, vres=16, hres=180)
    return base


def _config(basepath, logdir, **evaluation):
    return {
        "data": {"basepath": basepath},
        "logging": {"basedir": os.path.dirname(logdir), "logdir": logdir},
        "model": MODEL,
        "training": {"batch_size": 4, "num_epochs": 1},
        "evaluation": {
            "accept_inverted_angle": True, "scale_residuals": True,
            "resolve_flips": True,
            "refinement_gate": {"enabled": True, "max_dyaw_deg": 2.0,
                                "max_dxy": 0.15},
            **evaluation},
    }


@contextlib.contextmanager
def _traced():
    """The port's spans, live under a host-only profiler over the block;
    yields the recorder's span aggregates, filled on exit."""
    tracing.reset()
    spans = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        yield spans
    spans.update(tracing.snapshot()["spans"])


def _workspaces(source, root):
    """A copy of the dataset for each package (both write packed caches
    next to it) and its log directory, keyed "jax" and "port"."""
    out = {}
    for name in ("jax", "port"):
        base = str(root / name / "data")
        shutil.copytree(source, base)
        out[name] = (base, str(root / name / "runs" / "stack"))
    return out


def _store_predictions(basepath, logdir, seed=0):
    """Near-truth 'network' predictions about the ground-truth centre, as
    an earlier eval of epoch 0 would have stored them."""
    ds = jp.PackedDataset(basepath, cache=False)
    val = jp.getDataFiles(f"{basepath}/split/val.txt")
    rows = ds.rows(val)
    rng = np.random.default_rng(seed)
    n = len(val)
    preds = {
        "pred_translations": ds.translations[rows]
        + rng.normal(0, 0.04, (n, 3)) * [1, 1, 0],
        "pred_angles": ds.rel_angles[rows].reshape(n, 1)
        + rng.normal(0, 0.02, (n, 1)),
        "pred_s2_pc1centers": ds.pc1centers[rows],
    }
    ev = os.path.join(logdir, "val", "eval000000")
    os.makedirs(ev, exist_ok=True)
    for key, arr in preds.items():
        np.save(os.path.join(ev, f"{key}.npy"), arr.astype(np.float32))


def _config_file(d, logdir):
    """``d`` as a config file whose name, ``stack``, load_config turns
    into the log directory basedir/stack (= ``logdir``)."""
    d = json.loads(json.dumps(d))
    del d["logging"]["logdir"]
    os.makedirs(os.path.dirname(logdir), exist_ok=True)
    path = os.path.join(os.path.dirname(logdir), "stack.json")
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _close(got, want, path=""):
    """Recursive comparison of two eval.json trees."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            if key != "mean_time":
                _close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert np.isclose(got, want, rtol=TOL, atol=TOL, equal_nan=True), (
            path, got, want)
    else:
        assert got == want, path


def _same_refined(dirs):
    j, t = dirs["jax"], dirs["port"]
    for key in PREDS:
        got, want = np.load(f"{t}/{key}.npy"), np.load(f"{j}/{key}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key == "pred_angles":
            got = np.mod(got - want + np.pi, 2 * np.pi) - np.pi
            want = np.zeros_like(want)
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=key)
    for name in ("eval.json", "eval_180.json"):
        with open(f"{t}/{name}") as a, open(f"{j}/{name}") as b:
            _close(json.load(a), json.load(b))


def test_trainer_refines_stored_predictions_like_jax(source, tmp_path):
    ws = _workspaces(source, tmp_path)
    dirs = {}
    for name, (base, logdir) in ws.items():
        _store_predictions(base, logdir)
        d = _config(base, logdir, refinement={"cascade": CASCADE})
        kwargs = dict(eval_only=True, eval_epoch=0, refine_icp=True,
                      use_old_results=True)
        if name == "jax":
            JaxTrainer(jax_config_from_dict(d), seed=0).train(**kwargs)
        else:
            trainer = Trainer(config_from_dict(d), seed=0, device="cpu")
            with _traced() as spans:
                trainer.train(**kwargs)
        dirs[name] = f"{logdir}/val/eval000000/refined_p2p"
    _same_refined(dirs)
    # the port spans each cascade stage's ICP
    assert spans["eval.icp_stage"]["count"] == len(CASCADE)


def test_cli_refines_stored_predictions_like_jax(source, tmp_path):
    ws = _workspaces(source, tmp_path)
    dirs = {}
    for name, (base, logdir) in ws.items():
        _store_predictions(base, logdir, seed=1)
        d = _config(base, logdir, refinement={"cascade": CASCADE})
        path = _config_file(d, logdir)
        argv = ["eval_only", "--config", path, "--refineICP",
                "--use_old_results", "--eval_epoch", "0", "--its", "12",
                "--refineICPmethod", "p2plane"]
        if name == "jax":
            jax_cli.main(argv)
        else:
            trainer = cli.main(argv + ["--device", "cpu"])
            assert trainer.device == torch.device("cpu")
        dirs[name] = f"{logdir}/val/eval000000/refined_p2plane_12"
    _same_refined(dirs)


@pytest.mark.parametrize("gate", ["default", "wide"])
def test_network_refine_pass_matches_jax(source, tmp_path, gate):
    """The same seeded weights (the port's init, bridged by to_flax), the
    same val batches (both packages on their default, native path) and the
    same first pass: the same gated composition."""
    ws = _workspaces(source, tmp_path)
    net_ref = {"enabled": True}
    if gate == "wide":
        net_ref["gate"] = {"max_dyaw_deg": 180.0, "max_dxy": 1e9}
    cfgs = {name: _config(base, logdir, network_refine=net_ref)
            for name, (base, logdir) in ws.items()}
    port = Trainer(config_from_dict(cfgs["port"]), seed=0, device="cpu")
    port.init_state()
    jtr = JaxTrainer(jax_config_from_dict(cfgs["jax"]), seed=0,
                     use_mesh=False)
    variables = to_flax(port.model.state_dict())
    state = jtr.init_state().replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))

    val = list(port.val_indices)
    rng = np.random.default_rng(2)
    P = {"pred_translations": rng.normal(0, 0.3, (len(val), 3)),
         "pred_angles": rng.normal(0, 0.5, (len(val), 1)),
         "pred_s2_pc1centers": rng.normal(0, 2.0, (len(val), 3))}
    P = {k: v.astype(np.float32) for k, v in P.items()}
    scale = np.pi / MODEL["angles"]["num_bins"]
    want = jtr._network_refine_pass(
        state, jtr._get_jitted("eval"), dict(P), val, 4, scale,
        jtr.cfg.evaluation.network_refine, resolve_flips=True, iteration=1)
    got = port._network_refine_pass(
        dict(P), val, 4, scale, port.cfg.evaluation.network_refine,
        resolve_flips=True, iteration=1)
    for key in PREDS:
        assert got[key].dtype == np.float32 and got[key].shape == P[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=TOL, err_msg=key)
    moved = np.abs(got["pred_translations"] - P["pred_translations"]).max(1)
    assert (moved > 1e-3).any()  # some pair took the second pass
    assert not got["pred_s2_pc1centers"].any()


def test_network_refine_weights_checkpoint_is_loaded_and_cached(source,
                                                                tmp_path):
    base, logdir = _workspaces(source, tmp_path)["port"]
    trainer = Trainer(config_from_dict(_config(
        base, logdir, network_refine={"enabled": True})), seed=0,
        device="cpu")
    trainer.init_state()
    trainer.save_checkpoint("refiner")
    ref = config_from_dict({"evaluation": {"network_refine": {
        "enabled": True, "weights": os.path.join(logdir, "refiner")}}})
    P = {"pred_translations": np.zeros((6, 3), np.float32),
         "pred_angles": np.zeros((6, 1), np.float32),
         "pred_s2_pc1centers": np.zeros((6, 3), np.float32)}
    plain = trainer._network_refine_pass(
        dict(P), list(trainer.val_indices), 4, 1.0,
        trainer.cfg.evaluation.network_refine)
    with_weights = trainer._network_refine_pass(
        dict(P), list(trainer.val_indices), 4, 1.0,
        ref.evaluation.network_refine)
    model = trainer._refine_model[1]
    assert model is not trainer.model
    for key in PREDS:  # the same weights give the same pass
        np.testing.assert_array_equal(with_weights[key], plain[key])
    trainer._network_refine_pass(dict(P), list(trainer.val_indices), 4, 1.0,
                                 ref.evaluation.network_refine)
    assert trainer._refine_model[1] is model


def test_timings_mode_prints_ten_timings(source, tmp_path, capsys):
    base, logdir = _workspaces(source, tmp_path)["port"]
    d = _config(base, logdir, special={"mode": "timings"})
    path = _config_file(d, logdir)
    trainer = cli.main(["eval_only", "--config", path, "--eval_epoch", "0",
                        "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Timing bs=")]
    assert len(lines) == 10 and all(ln.startswith("Timing bs=32: ")
                                    for ln in lines)
    assert all(float(ln.split(": ")[1]) > 0 for ln in lines)
    assert trainer.batch_size == 32
    ev = f"{logdir}/val/eval000000"
    assert os.path.isfile(f"{ev}/pred_translations.npy")
    assert not os.path.exists(f"{ev}/eval.json")  # timings write no metrics
    # the same through Trainer.train at another batch size
    Trainer(config_from_dict(_config(base, logdir)), device="cpu").train(
        eval_only=True, eval_epoch=0, do_timings=True, override_batch_size=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Timing bs=")]
    assert len(lines) == 10 and lines[0].startswith("Timing bs=2: ")


def test_full_stack_trains_and_refines(source, tmp_path):
    """The headline stack at a small size: the component filter and voxel
    views, a gated second network pass in every eval, and gated p2plane
    ICP after it, trained for an epoch and evaluated through the CLI."""
    base, logdir = _workspaces(source, tmp_path)["port"]
    d = _config(base, logdir,
                network_refine={"enabled": True,
                                "gate": {"max_dyaw_deg": 2.0,
                                         "max_dxy": 0.15}},
                refinement={"method": "p2plane", "radius": 0.1})
    d["data"]["denoise"] = {"cell": 0.5, "keep": "largest"}
    d["data"]["resample"] = {"mode": "voxel", "voxel_size": 0.05}
    path = _config_file(d, logdir)
    with _traced() as spans:
        trainer = cli.main(["train", "--config", path, "--device", "cpu"])
    assert trainer.dataset._denoise_tag == "dn0.5l"
    assert trainer.dataset._vox_size == 0.05
    assert spans["eval.network_refine"]["count"] == 1
    assert os.path.isfile(f"{logdir}/model-0.pt")
    # the refinement method comes from the config, whatever the flag says
    with _traced() as spans:
        cli.main(["eval_only", "--config", path, "--refineICP",
                  "--eval_epoch", "0", "--refineICPmethod", "p2p",
                  "--device", "cpu"])
    ev = f"{logdir}/val/eval000000/refined_p2plane"
    for name in ("eval.json", "eval_180.json"):
        assert os.path.isfile(f"{ev}/{name}")
    for key in ("pred_translations", "pred_angles", "pred_s1_pc1centers",
                "pred_s1_pc2centers", "pred_s2_pc1centers",
                "pred_s2_pc2centers", "pred_s2_pc1angles",
                "pred_s2_pc2angles"):
        arr = np.load(f"{ev}/{key}.npy")
        assert arr.shape[0] == 6 and np.isfinite(arr).all(), key
    assert not np.load(f"{ev}/pred_s2_pc1centers.npy").any()
    assert spans["eval.icp_stage"]["count"] == 1
