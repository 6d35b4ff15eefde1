"""The port's data-parallel selection and data sharding against the JAX
package: ``choose_dp`` and ``balanced_process_devices`` on the cases of
tests/test_mesh_selection.py (assert messages included),
``PackedDataset.shard_indices``, and each process's training batches
against the batches the JAX package's processes draw (its
``shard_indices`` + ``sample_batch`` from ``Trainer._epoch_rng(1, e)``,
with the stand-in of tests/test_multihost.py). Also the single-process
behaviour of ``parallel/multihost.py`` and the refusal of ``tpu.mesh.mp``."""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from alignnet3d_tpu.data import provider as jax_provider
from alignnet3d_tpu.parallel import mesh as jax_mesh
from alignnet3d_tpu.training.trainer import Trainer as JaxTrainer
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data import provider
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.parallel import mesh, multihost
from alignnet3d_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except AssertionError as e:
        return ("assert", str(e))


CHOOSE_DP = [(8, 12, 1), (8, 16, 1), (8, 7, 1), (3, 7, 1), (8, 12, 2),
             (8, 14, 2), (8, 10, 4), (8, 16, 2), (4, 128, 4), (2, 6, 4)]


@pytest.mark.parametrize("dp,batch,procs", CHOOSE_DP)
def test_choose_dp_matches_jax(dp, batch, procs):
    want = _outcome(jax_mesh.choose_dp, dp, batch, num_processes=procs)
    assert _outcome(mesh.choose_dp, dp, batch, num_processes=procs) == want


def _fake_devices(counts):
    return [types.SimpleNamespace(process_index=p, id=p * 100 + i)
            for p, n in counts.items() for i in range(n)]


@pytest.mark.parametrize("counts,dp,mp,procs", [
    ({0: 4, 1: 4}, 6, 1, 2), ({0: 4, 1: 4}, 2, 2, 2),
    ({0: 4, 1: 4}, 3, 2, 2), ({0: 4, 1: 1}, 4, 1, 2)])
def test_balanced_process_devices_matches_jax(counts, dp, mp, procs):
    devs = _fake_devices(counts)
    want = _outcome(jax_mesh.balanced_process_devices, devs, dp, mp, procs)
    got = _outcome(mesh.balanced_process_devices, devs, dp, mp, procs)
    if want[0] == "ok":
        want, got = (want[0], [d.id for d in want[1]]), (got[0], [
            d.id for d in got[1]])
    assert got == want


@pytest.mark.parametrize("n,hosts", [(103, 4), (16, 2), (5, 8)])
def test_shard_indices_matches_jax(n, hosts):
    idxs = list(np.random.default_rng(n).permutation(n))
    for h in range(hosts):
        assert provider.PackedDataset.shard_indices(idxs, h, hosts) == \
            jax_provider.PackedDataset.shard_indices(idxs, h, hosts)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One fixture dataset, a copy for each package (both write caches
    next to it)."""
    root = tmp_path_factory.mktemp("parallel_data")
    base = str(root / "port")
    generate_dataset(base, num_train=19, num_val=4, seed=6, vres=16,
                     hres=180)
    shutil.copytree(base, str(root / "jax"))
    return base, str(root / "jax")


def _jax_process_batches(base, seed, epoch, batch_size, rank, procs,
                         num_points):
    """The batches the JAX package's process ``rank`` of ``procs`` draws
    in ``epoch`` (trainer.py:640-672)."""
    class T:  # the helper reads only self.seed (tests/test_multihost.py)
        _epoch_rng = JaxTrainer._epoch_rng

    t = T()
    t.seed = seed
    ds = jax_provider.PackedDataset(base)
    epoch_rng = t._epoch_rng(1, epoch)
    idxs = np.asarray(jax_provider.getDataFiles(
        f"{base}/split/train.txt")).copy()
    epoch_rng.shuffle(idxs)
    num_batches = len(idxs) // batch_size
    idxs = np.asarray(jax_provider.PackedDataset.shard_indices(
        idxs, rank, procs))
    lbs = batch_size // procs
    return [ds.sample_batch(idxs[i * lbs:(i + 1) * lbs], num_points,
                            epoch_rng) for i in range(num_batches)]


@pytest.mark.parametrize("procs", [2, 3])
def test_process_batches_match_jax(datasets, tmp_path, procs):
    base, jax_base = datasets
    cfg = config_from_dict({
        "data": {"basepath": base},
        "logging": {"basedir": str(tmp_path), "logdir": str(tmp_path)},
        "model": {"backbone": "pointnet", "num_points": 16, "options": {
            "s1transformer": [[8], [[8], 0.7]],
            "s2transformer": [[8], [[8], 0.7]], "embedding": [8],
            "remaining_transform_prediction": [[8], 0.7]}},
        "training": {"batch_size": 6},
    })
    for rank in range(procs):
        trainer = Trainer(cfg, seed=5, device="cpu")
        # this process's place in a run of ``procs`` (no process group:
        # the epoch's data path alone)
        trainer.num_processes, trainer.process_index = procs, rank
        trainer.local_batch_size = 6 // procs
        seen = []
        zero = torch.zeros(())
        trainer.train_step = lambda b: (seen.append(b),
                                        {"losses/loss": zero})[1]
        for epoch in (0, 1):
            seen.clear()
            trainer.train_one_epoch(epoch, None)
            want = _jax_process_batches(jax_base, 5, epoch, 6, rank, procs,
                                        16)
            assert len(seen) == len(want) == 3
            for got_b, want_b in zip(seen, want):
                for g, w in zip(got_b, want_b):
                    np.testing.assert_array_equal(np.asarray(g),
                                                  np.asarray(w))


def test_multihost_single_process(tmp_path):
    assert not multihost.maybe_initialize()  # no ALIGNNET_* variables
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_main()
    path = tmp_path / "f"
    assert not multihost.main_isfile(str(path))
    path.write_text("x")
    assert multihost.main_isfile(str(path))
    tree = {"a": torch.ones(2), "b": [1, "c"]}
    assert multihost.broadcast_tree(tree) is tree
    x = torch.arange(3.0, requires_grad=True)
    assert multihost.all_reduce_sum(x) is x
    assert multihost.all_gather_rows(x) is x
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_row_shard_takes_this_process_rows():
    shard = multihost.RowShard(lo=2, local=2, total=6)
    full = torch.arange(12.0 * 3).reshape(12, 3)
    got = shard.take(lambda shape: full[:shape[0]], (4, 3))
    # two blocks (a stacked Siamese batch): rows 2-3 and 8-9 of 12
    assert torch.equal(got, full[[2, 3, 8, 9]])


def test_tensor_parallel_config_is_refused():
    cfg = config_from_dict({"tpu": {"mesh": {"dp": -1, "mp": 2}}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.data_parallel_width(cfg, 8, 1)
    assert mesh.data_parallel_width(config_from_dict({}), 8, 2) == 2
    with pytest.raises(AssertionError, match="must divide over 3 processes"):
        mesh.data_parallel_width(config_from_dict({}), 8, 3)


def test_maybe_initialize_reads_the_environment(monkeypatch):
    """The three variables are JAX's; without a coordinator nothing joins."""
    assert (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCS,
            multihost.ENV_PROC_ID) == (
        "ALIGNNET_COORDINATOR", "ALIGNNET_NUM_PROCS", "ALIGNNET_PROC_ID")
    monkeypatch.delenv("ALIGNNET_COORDINATOR", raising=False)
    assert os.environ.get("ALIGNNET_COORDINATOR") is None
    assert multihost.maybe_initialize() is False
