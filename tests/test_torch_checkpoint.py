"""Checkpoints across the two packages on the CPU (``checkpoint.py``).

- The codec: every msgpack type of the subset flax writes, against the
  ``msgpack`` package with flax's ext hooks, byte for byte; malformed
  input and unknown ext codes raise.
- The reader: a flax ``TrainState`` (tests/torch_parity.py's weights after
  3 optax updates, Adam and momentum SGD) read bit-exactly, chunked arrays
  included, and mapped into the port's model and optimizer and back.
- The writer: its bytes equal ``flax.serialization.to_bytes``'.
- The trainers: the port resumes a JAX run from its rolling
  ``model.ckpt.msgpack`` and fine-tunes from a JAX ``pretraining.model``,
  and the JAX package fine-tunes from a port run written by the writer;
  each time the parameters after the next epoch agree with the JAX
  ``Trainer``'s. The learning rate decays every step, so a fine-tune that
  applied the schedule at the reset step rather than at the optimizer's
  restored count would take 16 times the JAX package's rate.
- ``Aligner.from_checkpoint`` of a JAX run in both packages, with flips,
  with the second network pass and a refiner's weights, and with the
  voxel and component-filter pickups from the config.

Tolerances: the fine-tune's update (weights after minus before) per
leaf, relative L2 within 1e-3 (the float32 gradient gap of
tests/test_torch_train_step.py, carried through two steps), a leaf whose
true gradient is 0 held to a floor of 1% of the whole update's norm; under
Adam the biases whose gradient is 0 in exact arithmetic (those a BN
follows, directly or through the max over points) are left out, since
Adam scales their float32-noise gradients to full-size steps of random
sign (measured: relative gaps up to 0.59 there, 4.4e-4 elsewhere).
BN statistics within 1e-5 absolute, and under Adam within 2e-4: the
running mean of a BN moves with the zero-gradient bias before it, which
the two packages step by up to the two applied rates (9.4e-5) each way
(measured: 2.6e-5). Serving answers within 1e-4
(tests/test_torch_slice.py).
"""

import json
import os
import shutil

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

import alignnet3d_tpu.training.trainer as jax_trainer_module
from alignnet3d_tpu.api import Aligner as JaxAligner
from alignnet3d_tpu.config import config_from_dict as jax_config_from_dict
from alignnet3d_tpu.training.trainer import Trainer as JaxTrainer
from alignnet3d_tpu.training.trainer import TrainState
from alignnet3d_tpu_torch import checkpoint
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu_torch.training import schedules
from alignnet3d_tpu_torch.training.trainer import Trainer
from alignnet3d_tpu_torch.weights import from_flax, to_flax

torch.set_num_threads(1)

UPDATE_TOL = 1e-3
STATS_ATOL = {"momentum": 1e-5, "adam": 2e-4}
ALIGN_TOL = 1e-4
NO_DROPOUT_MODEL = {
    "backbone": "pointnet", "num_points": 32,
    "options": {
        "s1transformer": [[8, 16], [[16], 1.0]],
        "s2transformer": [[8, 16], [[16], 1.0]],
        "embedding": [8, 16],
        "remaining_transform_prediction": [[16], 1.0],
    },
    "angles": {"num_bins": 8, "accept_inverted_angle": True},
}
OPTIMIZERS = {"adam": {"optimizer": "adam"},
              "momentum": {"optimizer": "momentum", "momentum": 0.9}}
# 8 train pairs at batch 4: 2 steps an epoch; the rate halves every step
# (a step of 4 samples), 1e-3 at step 0, 6.25e-5 at step 4
TRAINING = {"batch_size": 4, "num_epochs": 2, "learning_rate": 1e-3,
            "lr_extension": {"mode": "decay", "per": "step", "step": 4,
                             "rate": 0.5},
            "loss": {"options": {"composite_translation": True,
                                 "flip_aware_composite": True}}}


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype \
            and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ------------------------------------------------------------------ codec

def _flax_packb(obj):
    return msgpack.packb(obj, default=fs._msgpack_ext_pack,
                         strict_types=True)


def _flax_unpackb(data):
    return msgpack.unpackb(data, ext_hook=fs._msgpack_ext_unpack, raw=False)


CODEC_CASES = {
    "nil": None, "true": True, "false": False,
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -1.5, 1e-300, float("inf")],
    "str": ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256, "d" * 70000,
            "unicode é"],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    "array": [list(range(15)), list(range(16)), list(range(70000))],
    "map": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {str(i): i for i in range(70000)}],
    "ndarrays": [np.arange(6, dtype=np.float32).reshape(2, 3),
                 np.zeros((0, 4), np.float64), np.asarray(7, np.int32),
                 np.arange(3, dtype=np.uint8), np.ones(5, bool),
                 np.arange(40000, dtype=np.int64)],
    "numpy scalars": [np.float32(1.5), np.int64(-3), np.float64(2.0),
                      np.bool_(True)],
    "complex": [1.5 - 2j],
    "nested": {"a": {"b": [1, {"c": np.ones(3, np.float16)}]}},
}


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_codec_writes_and_reads_as_msgpack_with_flax_hooks(name):
    value = CODEC_CASES[name]
    data = checkpoint.packb(value)
    assert data == _flax_packb(value)
    got, want = checkpoint.unpackb(data), _flax_unpackb(data)
    assert repr(got) == repr(want)
    for (_, g), (_, w) in zip(_flat({"v": got}), _flat({"v": want})):
        assert type(g) is type(w)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("data,match", [
    (b"\xd4\x05\x00", "ext type 5"),                 # fixext 1, code 5
    (b"\xc7\x02\x7f\x00\x00", "ext type 127"),       # ext 8, code 127
    (b"\xc1", "type byte 0xc1"),                     # never used
    (b"\x92\x01", "ends at byte 2"),                 # array of 2, one item
    (b"\x01\x02", "1 bytes after"),                  # trailing data
])
def test_malformed_or_unknown_input_raises(data, match):
    with pytest.raises(ValueError, match=match):
        checkpoint.unpackb(data)


def test_unwritable_values_raise():
    for value in ({1, 2}, object(), np.array([object()])):
        with pytest.raises(TypeError):
            checkpoint.packb(value)


# ------------------------------------------------------- reader and writer

def _train_state(name: str):
    """tests/torch_parity.py's weights after 3 optax updates of random
    gradients, as the JAX ``TrainState`` at step 3."""
    _, variables = trained_variables()
    tx = (optax.adam(lambda c: 1e-3 * 0.5 ** c) if name == "adam"
          else optax.sgd(lambda c: 1e-3, momentum=0.9))
    params = variables["params"]
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape), p.dtype), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                      batch_stats=variables["batch_stats"],
                      opt_state=opt_state)


def _port_model_and_optimizer(name: str):
    model = AlignNet(torch_spec(SPEC))
    opt = (torch.optim.Adam(model.parameters()) if name == "adam"
           else torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9))
    return model, opt


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_reader_reads_a_flax_train_state_bit_exactly(name, tmp_path):
    state = _train_state(name)
    data = fs.to_bytes(state)
    want = to_numpy_tree(fs.msgpack_restore(data))
    got = checkpoint.msgpack_restore(data)
    _assert_trees_equal(got, want)
    assert got["step"].dtype == np.int32 and got["step"] == 3
    assert got["opt_state"]["1"]["count"] == 3
    if name == "adam":
        assert got["opt_state"]["0"]["count"] == 3

    # into the port's model and optimizer and back: the same tree
    path = str(tmp_path / "model-0.msgpack")
    with open(path, "wb") as f:
        f.write(data)
    model, opt = _port_model_and_optimizer(name)
    restored = checkpoint.load(str(tmp_path / "model-0"), model, opt)
    assert restored == {"step": 3, "schedule_count": 3}
    first = opt.state[next(model.parameters())]
    if name == "adam":
        assert float(first["step"]) == 3.0
    else:
        assert "momentum_buffer" in first
    _assert_trees_equal(
        checkpoint.train_state_tree(model, opt, 3, 3), want)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_writer_bytes_equal_flax_to_bytes(name):
    state = _train_state(name)
    data = fs.to_bytes(state)
    assert checkpoint.to_bytes(checkpoint.msgpack_restore(data)) == data
    # and the JAX package restores what the port writes from its own state
    model, opt = _port_model_and_optimizer(name)
    tree = checkpoint.msgpack_restore(data)
    model.load_state_dict(from_flax(tree))
    written = checkpoint.to_bytes(checkpoint.train_state_tree(
        model, opt, 0, 0))
    back = fs.from_bytes(state, written)
    assert int(back.step) == 0 and int(back.opt_state[1].count) == 0
    _assert_trees_equal(to_numpy_tree(back.params),
                        to_numpy_tree(state.params))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_chunked_arrays_read_and_write_as_flax(name, monkeypatch):
    state = _train_state(name)
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    data = fs.to_bytes(state)
    assert b"__msgpack_chunked_array__" in data
    got = checkpoint.msgpack_restore(data)
    _assert_trees_equal(got, to_numpy_tree(fs.msgpack_restore(data)))
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 256)
    assert checkpoint.to_bytes(got) == data


def test_bare_variables_load_as_weights(tmp_path):
    _, variables = trained_variables()
    path = str(tmp_path / "bare.msgpack")
    with open(path, "wb") as f:
        f.write(fs.to_bytes(variables))
    model, opt = _port_model_and_optimizer("adam")
    assert checkpoint.load(path, model, opt) == {"step": None,
                                                 "schedule_count": 0}
    assert not opt.state
    want = from_flax(to_numpy_tree(variables))
    for key, value in checkpoint.state_dict_from_file(path).items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)


def test_suffix_rules(tmp_path):
    model, opt = _port_model_and_optimizer("adam")
    base = str(tmp_path / "model-3")
    with pytest.raises(FileNotFoundError, match="model-3.pt nor .*"
                       "model-3.msgpack"):
        checkpoint.resolve(base)
    assert checkpoint.find(base) is None
    checkpoint.save(base + ".msgpack", model, opt, 5, 5)
    assert checkpoint.resolve(base) == base + ".msgpack"
    checkpoint.save(base + ".pt", model, opt, 7, 7)
    assert checkpoint.resolve(base) == base + ".pt"
    assert checkpoint.load(base, model, opt)["step"] == 7
    assert checkpoint.load(base + ".msgpack", model, opt)["step"] == 5


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_pt_without_schedule_count_takes_the_optimizer_count(name,
                                                             tmp_path):
    """A ``.pt`` written before the count was stored: Adam's step, or the
    checkpoint's step for SGD."""
    model, opt = _port_model_and_optimizer(name)
    x = torch.zeros(2, 128, 3)
    for _ in range(3):
        opt.zero_grad()
        out = model.train()(x + torch.randn(x.shape), x, momentum=0.5)
        sum(v.sum() for v in out.values()).backward()
        opt.step()
    path = str(tmp_path / "old.pt")
    torch.save({"step": 3, "model": model.state_dict(),
                "optimizer": opt.state_dict()}, path)
    assert checkpoint.load(path, *_port_model_and_optimizer(name)) == {
        "step": 3, "schedule_count": 3}


# ---------------------------------------------------------------- trainers

class _Delegate:
    """A module stand-in: ``overrides`` first, then ``target``'s names."""

    def __init__(self, target, **overrides):
        self._target, self._overrides = target, overrides

    def __getattr__(self, name):
        if name in self._overrides:
            return self._overrides[name]
        return getattr(self._target, name)


# the JAX Trainer's device-side jitter draws jax.random.normal: zero here
# (and the port's _jitter the identity), so both steps see the same points
_NO_JITTER_JAX = _Delegate(jax, random=_Delegate(
    jax.random, normal=lambda key, shape, *a, **k: jnp.zeros(shape)))


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ckpt") / "src")
    generate_dataset(base, num_train=8, num_val=4, seed=6, vres=16, hres=180)
    return base


def _run_config(base, logdir, optimizer, **training):
    return {
        "data": {"basepath": base},
        "logging": {"basedir": os.path.dirname(logdir), "logdir": logdir},
        "model": NO_DROPOUT_MODEL,
        "training": {**TRAINING, "optimizer": OPTIMIZERS[optimizer],
                     **training},
        "evaluation": {"accept_inverted_angle": True,
                       "scale_residuals": True},
    }


def _workspace(source, root, name):
    base = str(root / name / "data")
    if not os.path.isdir(base):
        shutil.copytree(source, base)
    return base


def _jax_train(d):
    trainer = JaxTrainer(jax_config_from_dict(d), seed=0, use_mesh=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "jax", _NO_JITTER_JAX)
        state = trainer.train()
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    return to_numpy_tree(jax.device_get(variables)), int(state.step)


def _port_train(d):
    trainer = Trainer(config_from_dict(d), seed=0, device="cpu")
    trainer._jitter = lambda pcs: pcs
    trainer.train()
    return trainer


def _zero_gradient_biases(params: dict) -> set:
    """Paths of the biases whose gradient is 0 in exact arithmetic: a
    conv<i>/fc<i> bias that bn<i> follows, and each backbone's last BN
    bias, which shifts every cloud's pooled feature alike (the max over
    points commutes with it) and so is absorbed by the head's first BN
    (but for the clouds a relu zeroes in that channel)."""
    out = set()
    for path, _ in _flat(params):
        *mods, layer, leaf = path
        parent = params
        for m in mods:
            parent = parent[m]
        if leaf != "bias":
            continue
        if layer.startswith(("conv", "fc")) and \
                "bn" + layer.lstrip("convfc") in parent:
            out.add(path)
        if mods[-1].startswith("PointNetBackbone") and layer == max(
                (k for k in parent if k.startswith("bn")),
                key=lambda k: int(k[2:])):
            out.add(path)
    return out


def _assert_same_update(got, want, start, optimizer):
    """The port's update of the fine-tune (``got - start``) against the JAX
    package's (``want - start``), leaf by leaf (see the module docstring)."""
    skip = (_zero_gradient_biases(want["params"]) if optimizer == "adam"
            else set())
    g_all = dict(_flat(got["params"]))
    s_all = dict(_flat(start["params"]))
    w_upd = {p: w - s_all[p] for p, w in _flat(want["params"])
             if p not in skip}
    floor = 1e-2 * np.sqrt(sum(np.sum(u * u) for u in w_upd.values()))
    assert floor > 0
    for path, w in w_upd.items():
        err = np.linalg.norm((g_all[path] - s_all[path]) - w)
        assert err <= UPDATE_TOL * max(np.linalg.norm(w), floor), (
            path, err, np.linalg.norm(w))
    for path, w in _flat(want["batch_stats"]):
        np.testing.assert_allclose(dict(_flat(got["batch_stats"]))[path], w,
                                   rtol=0, atol=STATS_ATOL[optimizer],
                                   err_msg=str(path))


@pytest.fixture(scope="module", params=list(OPTIMIZERS))
def jax_run(request, source, tmp_path_factory):
    """A 2-epoch run of the JAX Trainer (4 steps): its directory holds
    model-0, model-1 and the rolling model.ckpt as .msgpack."""
    root = tmp_path_factory.mktemp(f"jax_run_{request.param}")
    logdir = str(root / "runs" / "pre")
    d = _run_config(_workspace(source, root, "jax"), logdir, request.param)
    _jax_train(d)
    return request.param, root, logdir


def test_port_resumes_a_jax_run_like_jax(jax_run, source):
    optimizer, root, logdir = jax_run
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(root / "resume" / name)
        shutil.copytree(logdir, dirs[name])
    want, step = _jax_train(_run_config(
        _workspace(source, root, "jax"), dirs["jax"], optimizer,
        num_epochs=3))
    port = _port_train(_run_config(
        _workspace(source, root, "port"), dirs["port"], optimizer,
        num_epochs=3))
    assert step == port.step == port.schedule_count == 6
    start = checkpoint.read_msgpack(os.path.join(logdir, "model.ckpt.msgpack"))
    _assert_same_update(to_flax(port.model.state_dict()), want, start,
                        optimizer)
    # the port writes its own format beside the JAX run's
    assert os.path.isfile(os.path.join(dirs["port"], "model-2.pt"))


def test_port_finetunes_from_jax_pretraining_like_jax(jax_run, source):
    """``training.pretraining.model`` of a JAX run, without its suffix: the
    step resets, the optimizer's count (4) and moments carry on, so both
    packages apply 6.25e-5 and 3.125e-5, not 1e-3 and 5e-4."""
    optimizer, root, logdir = jax_run
    pre = os.path.join(logdir, "model-1")
    want, step = _jax_train(_run_config(
        _workspace(source, root, "jax"), str(root / "ft" / "jax"), optimizer,
        num_epochs=1, pretraining={"model": pre}))
    port = _port_train(_run_config(
        _workspace(source, root, "port"), str(root / "ft" / "port"),
        optimizer, num_epochs=1, pretraining={"model": pre}))
    assert step == port.step == 2 and port.schedule_count == 6
    rows = [json.loads(line) for line in open(
        root / "ft" / "port" / "train" / "scalars.jsonl")]
    assert [r["hyperparameters/learning_rate"] for r in rows] == [
        schedules.learning_rate(s, port.cfg, 2) for s in (0, 1)]
    start = checkpoint.read_msgpack(pre + ".msgpack")
    _assert_same_update(to_flax(port.model.state_dict()), want, start,
                        optimizer)


def test_jax_finetunes_from_a_port_run_like_the_port(source, tmp_path):
    """The reverse: the port pretrains (``.pt``), the writer turns the
    run into a JAX ``TrainState`` file, and both packages fine-tune from
    it with the schedule at the optimizer's count."""
    base = _workspace(source, tmp_path, "port")
    pre_dir = str(tmp_path / "runs" / "pre")
    pretrained = _port_train(_run_config(base, pre_dir, "adam"))
    assert pretrained.schedule_count == 4
    pre = os.path.join(pre_dir, "model-1")
    model = AlignNet(pretrained.spec)
    opt = torch.optim.Adam(model.parameters())
    restored = checkpoint.load(pre + ".pt", model, opt)
    assert restored == {"step": 4, "schedule_count": 4}
    converted = str(tmp_path / "converted" / "model-1")
    checkpoint.save(converted + ".msgpack", model, opt, restored["step"],
                    restored["schedule_count"])
    want, _ = _jax_train(_run_config(
        _workspace(source, tmp_path, "jax"), str(tmp_path / "ft" / "jax"),
        "adam", num_epochs=1, pretraining={"model": converted}))
    port = _port_train(_run_config(
        base, str(tmp_path / "ft" / "port"), "adam", num_epochs=1,
        pretraining={"model": pre}))
    assert port.schedule_count == 6
    _assert_same_update(to_flax(port.model.state_dict()), want,
                        checkpoint.read_msgpack(converted + ".msgpack"),
                        "adam")


def test_pretraining_applies_the_rate_at_the_optimizer_count(source,
                                                             tmp_path):
    """The port alone, from its own ``.pt``: the rate applied in the
    fine-tune's first step is the schedule's at the restored count (4),
    and the rate logged is the schedule's at step 0."""
    base = _workspace(source, tmp_path, "port")
    pre_dir = str(tmp_path / "runs" / "pre")
    _port_train(_run_config(base, pre_dir, "momentum"))
    ft = Trainer(config_from_dict(_run_config(
        base, str(tmp_path / "runs" / "ft"), "momentum", num_epochs=1,
        pretraining={"model": os.path.join(pre_dir, "model-1")})),
        seed=0, device="cpu")
    applied = []
    step = torch.optim.SGD.step

    def spy(opt, *args, **kwargs):
        applied.append(opt.param_groups[0]["lr"])
        return step(opt, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.optim.SGD, "step", spy)
        ft.train()
    assert applied == [schedules.learning_rate(c, ft.cfg, 2) for c in (4, 5)]
    assert applied[0] == pytest.approx(6.25e-5)


# ------------------------------------------------------ from_checkpoint

@pytest.fixture(scope="module")
def jax_served_run(tmp_path_factory):
    """A JAX run of 2 epochs through its CLI (the fixture of
    tests/test_api.py, saving every epoch) and 6 pairs of its clouds."""
    root = tmp_path_factory.mktemp("served")
    base = str(root / "Data")
    generate_dataset(base, num_train=16, num_val=4, seed=71, vres=16,
                     hres=180)
    cfg = {
        "data": {"basepath": base},
        "logging": {"basedir": str(root / "runs")},
        "model": {
            "num_points": 64, "backbone": "pointnet",
            "options": {
                "s1transformer": [[16, 32], [[32], 0.7]],
                "s2transformer": [[16, 32], [[32], 0.7]],
                "embedding": [16, 64],
                "remaining_transform_prediction": [[32], 0.7],
            },
            "angles": {"num_bins": 8, "accept_inverted_angle": True},
        },
        "training": {"batch_size": 8, "num_epochs": 2,
                     "learning_rate": 0.005},
        "evaluation": {"save_every_epoch": True, "scale_residuals": True},
    }
    cfg_path = str(root / "Api.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    from alignnet3d_tpu.cli import main

    main(["train", "--config", cfg_path])
    logdir = root / "runs" / "Api"
    pcs1 = [np.load(f"{base}/pointcloud1/{i:08d}.npy") for i in range(6)]
    pcs2 = [np.load(f"{base}/pointcloud2/{i:08d}.npy") for i in range(6)]
    return logdir, pcs1, pcs2


def _config_with(logdir, name, **data):
    with open(logdir / "config.json") as f:
        d = json.load(f)
    d["data"].update(data)
    path = str(logdir / f"{name}.json")
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _same_answers(got, want, atol=ALIGN_TOL):
    assert got.keys() == want.keys()
    for key in ("transforms", "translations", "centers"):
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   err_msg=key)
    dang = np.mod(got["angles"] - want["angles"] + np.pi, 2 * np.pi) - np.pi
    assert np.max(np.abs(dang)) < atol


SERVE_CASES = {
    # name: (config's data overrides, align kwargs)
    "plain": ({}, {}),
    "flips": ({}, {"resolve_flips": True}),
    "network_refine": ({}, {"resolve_flips": True, "network_refine": True,
                            "refine_gate": (180.0, 1e9)}),
    "voxel": ({"resample": {"mode": "voxel", "voxel_size": 0.1}}, {}),
    "denoise": ({"denoise": {"cell": 0.5, "keep": "largest"}}, {}),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_from_checkpoint_serves_a_jax_run_like_jax(jax_served_run, case):
    logdir, pcs1, pcs2 = jax_served_run
    data, kwargs = SERVE_CASES[case]
    config = _config_with(logdir, case, **data)
    ckpt = str(logdir / "model-1.msgpack")
    ref = JaxAligner.from_checkpoint(config, ckpt, batch_size=4)
    port = Aligner.from_checkpoint(config, ckpt, batch_size=4, device="cpu")
    assert port.device == torch.device("cpu")
    assert port.residual_scale == ref.residual_scale == np.pi / 8
    assert port.voxel_resample == ref.voxel_resample
    assert port.denoise == ref.denoise
    if case == "voxel":
        assert port.voxel_resample == 0.1
    if case == "denoise":
        assert port.denoise == (0.5, "largest")
    if kwargs.get("network_refine"):
        refiner = str(logdir / "model-0.msgpack")
        with open(refiner, "rb") as f:
            tree = fs.msgpack_restore(f.read())
        ref_kwargs = dict(kwargs, refine_variables={
            "params": tree["params"], "batch_stats": tree["batch_stats"]})
        kwargs = dict(kwargs, refine_variables=checkpoint
                      .state_dict_from_file(refiner))
    else:
        ref_kwargs = kwargs
    _same_answers(port.align(pcs1, pcs2, **kwargs),
                  ref.align(pcs1, pcs2, **ref_kwargs))


def test_from_checkpoint_pt_and_msgpack_answer_alike(jax_served_run,
                                                     tmp_path):
    logdir, pcs1, pcs2 = jax_served_run
    config = str(logdir / "config.json")
    ckpt = str(logdir / "model-1.msgpack")
    with open(config) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))
    model = AlignNet(spec)
    opt = torch.optim.Adam(model.parameters())
    restored = checkpoint.load(ckpt, model, opt)
    pt = str(tmp_path / "model-1.pt")
    checkpoint.save(pt, model, opt, **restored)
    answers = [Aligner.from_checkpoint(config, path, batch_size=4,
                                       device="cpu").align(pcs1, pcs2)
               for path in (ckpt, pt)]
    for key in answers[0]:
        np.testing.assert_array_equal(answers[0][key], answers[1][key])
