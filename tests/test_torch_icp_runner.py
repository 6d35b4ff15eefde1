"""The port's standalone ICP evaluation (``evaluation.special.mode ==
'icp'``, ``alignnet3d_tpu_torch/icp/runner.py``) through its CLI on the CPU:
every variant of the baseline matrix (make_icp_configs.py) and
``multistart``, in eval_icp.sh's order, on the workspace of
``tests/test_icp_runner.py`` generated by the port's own generator.

Tolerances: ``p2point`` answers to 1e-4 m / 1e-4 rad of the JAX runner's on
a copy of the same dataset (the float32 / float64 pose-algebra gap,
tests/test_torch_icp.py). The other checks are exact: artifacts, the
``*_p2p`` variants' use of their base run, ``use_old_results``, and answers
bit-equal under another ``pair_chunk``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from alignnet3d_tpu_torch import cli
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.icp import runner

torch.set_num_threads(1)

POSE_TOL = 1e-4
# name (make_icp_configs.py VARIANTS) -> the config's icp block, in
# eval_icp.sh's order: each base before its *_p2p
MATRIX = {
    "o3_p2p": {"variant": "p2point"},
    "o3_gicp": {"variant": "o3_gicp"},
    "o3_gicp_fast": {"variant": "o3_gicp_fast"},
    "o3_gicp_p2p": {"variant": "o3_gicp", "refine": "p2p"},
    "o3_gicp_fast_p2p": {"variant": "o3_gicp_fast", "refine": "p2p"},
}
PREDS = ("pred_translations", "pred_angles", "pred_s1_pc1centers")


def _config_file(root, base, name, icp):
    cfg = {
        "data": {"basepath": base},
        "logging": {"basedir": str(root / "runs")},
        "evaluation": {"special": {"mode": "icp", "icp": {
            "with_constraint": True, **icp}}},
    }
    path = str(root / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _eval_dir(root, name):
    return root / "runs" / "icp_SynthICP" / name / "val" / "eval000000"


def _run(root, base, name, icp, *flags):
    path = _config_file(root, base, name, icp)
    return cli.main(["train", "--config", path, "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The dataset of tests/test_icp_runner.py (clouds of 99-3,168 points),
    and the five matrix variants run through the CLI in eval_icp.sh's
    order."""
    root = tmp_path_factory.mktemp("icp_port")
    base = str(root / "SynthICP")
    generate_dataset(base, num_train=4, num_val=8, seed=21, vres=24,
                     hres=480)
    # the JAX package's copy, before either package writes its caches
    shutil.copytree(base, str(root / "jax" / "SynthICP"))
    for vname, icp in MATRIX.items():
        _run(root, base, f"icp_SynthICP_{vname}", icp)
    return root, base


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A smaller dataset (clouds of tens to hundreds of points) for the
    multi-start variant and the chunking checks."""
    root = tmp_path_factory.mktemp("icp_port_small")
    base = str(root / "SynthICP")
    generate_dataset(base, num_train=2, num_val=8, seed=5, vres=16,
                     hres=180)
    _run(root, base, "icp_SynthICP_multistart", {"variant": "multistart"})
    return root, base


@pytest.mark.parametrize("name", list(MATRIX) + ["multistart"])
def test_artifacts(name, workspace, small):
    root, _ = small if name == "multistart" else workspace
    ev = _eval_dir(root, f"icp_SynthICP_{name}")
    for f in ("eval.json", "eval_180.json"):
        assert (ev / f).is_file()
    t = np.load(ev / "pred_translations.npy")
    a = np.load(ev / "pred_angles.npy")
    c = np.load(ev / "pred_s1_pc1centers.npy")
    assert t.shape == (8, 3) and a.shape == (8, 1) and c.shape == (8, 3)
    assert t.dtype == a.dtype == c.dtype == np.float32
    assert np.isfinite(t).all() and np.isfinite(a).all()
    assert np.all(c == 0)  # world-frame convention (icp.py:196-198)
    with open(ev / "eval.json") as f:
        d = json.load(f)
    assert d["num"] == 8 and d["mean_time"] > 0


def test_p2point_matches_the_jax_runner(workspace):
    from alignnet3d_tpu import cli as jax_cli

    root, _ = workspace
    path = _config_file(root / "jax", str(root / "jax" / "SynthICP"),
                        "icp_SynthICP_o3_p2p", MATRIX["o3_p2p"])
    jax_cli.main(["train", "--config", path])
    got, want = (_eval_dir(r, "icp_SynthICP_o3_p2p") for r in
                 (root, root / "jax"))
    for name, tol in (("pred_translations", POSE_TOL),
                      ("pred_angles", POSE_TOL)):
        np.testing.assert_allclose(np.load(got / f"{name}.npy"),
                                   np.load(want / f"{name}.npy"), atol=tol)
    with open(got / "eval.json") as f, open(want / "eval.json") as g:
        assert json.load(f)["num"] == json.load(g)["num"]


@pytest.mark.parametrize("base_name", ["o3_gicp", "o3_gicp_fast"])
def test_p2p_variant_refines_the_base_run(base_name, workspace):
    """The *_p2p run reads its base's answers (logdir[:-4]) and adds the
    base's mean time (reference icp.py:160-170); without the base it
    stops."""
    root, base = workspace
    ev_base = _eval_dir(root, f"icp_SynthICP_{base_name}")
    ev = _eval_dir(root, f"icp_SynthICP_{base_name}_p2p")
    with open(ev / "eval.json") as f, open(ev_base / "eval_180.json") as g:
        assert json.load(f)["mean_time"] >= json.load(g)["mean_time"]
    assert not np.array_equal(np.load(ev / "pred_translations.npy"),
                              np.load(ev_base / "pred_translations.npy"))
    with pytest.raises(AssertionError, match="icp_Other_"):
        _run(root, base, f"icp_Other_{base_name}_p2p",
             MATRIX[f"{base_name}_p2p"])


def test_use_old_results_reads_the_stored_answers(workspace):
    root, base = workspace
    ev = _eval_dir(root, "icp_SynthICP_o3_gicp")
    stored = {k: np.load(ev / f"{k}.npy") for k in PREDS}
    moved = stored["pred_translations"] + np.float32(0.5)
    np.save(ev / "pred_translations.npy", moved)
    with open(ev / "eval.json") as f:
        before = json.load(f)
    _run(root, base, "icp_SynthICP_o3_gicp", MATRIX["o3_gicp"],
         "--use_old_results")
    np.testing.assert_array_equal(np.load(ev / "pred_translations.npy"),
                                  moved)
    with open(ev / "eval.json") as f:
        after = json.load(f)
    assert after["mean_dist_translation"] != before["mean_dist_translation"]
    np.save(ev / "pred_translations.npy", stored["pred_translations"])


@pytest.mark.parametrize("variant", ["p2point", "o3_gicp", "o3_gicp_fast",
                                     "multistart"])
def test_answers_do_not_depend_on_pair_chunk(variant, small, tmp_path):
    """A pair's clouds, padding and random draws are its own: chunks of 2
    and of 8 pairs give bit-equal answers."""
    _, base = small
    preds = []
    for chunk in (2, 8):
        logdir = str(tmp_path / f"chunk{chunk}")
        cfg = config_from_dict({
            "data": {"basepath": base},
            "logging": {"basedir": str(tmp_path), "logdir": logdir},
            "evaluation": {"special": {"mode": "icp", "icp": {
                "variant": variant, "with_constraint": True}}}})
        runner.evaluate(cfg, pair_chunk=chunk, device="cpu")
        ev = os.path.join(logdir, "val", "eval000000")
        preds.append([np.load(os.path.join(ev, f"{k}.npy")) for k in PREDS])
    for a, b in zip(*preds):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vname", list(MATRIX))
def test_matrix_configs_reach_the_runner(vname, tmp_path, monkeypatch):
    """Every config make_icp_configs.py writes loads in the port's loader
    and reaches the runner with its variant, on the card by default."""
    import make_icp_configs

    calls = []

    def evaluate(cfg, use_old_results, *, device):
        icp = cfg.evaluation.special.icp
        calls.append((cfg.name, icp.variant, icp.get("refine"),
                      use_old_results, device))

    monkeypatch.setattr(runner, "evaluate", evaluate)
    names = make_icp_configs.main(basedir=str(tmp_path), data_root="data")
    assert len(names) == 40
    mine = [n for n in names if n.endswith(f"_{vname}")]
    assert len(mine) == len(make_icp_configs.DATASETS)
    for i, name in enumerate(mine):
        argv = ["train", "--config", str(tmp_path / f"{name}.json")]
        cli.main(argv + (["--device", "cpu"] if i % 2 else []))
    icp = MATRIX[vname]
    assert calls == [(name, icp["variant"], icp.get("refine"), False,
                      "cpu" if i % 2 else "cuda")
                     for i, name in enumerate(mine)]


def test_no_card_is_an_error_not_a_fallback(small, tmp_path):
    """On the card (the default) the runner never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    _, base = small
    for name in ("o3_p2p", "o3_gicp", "o3_gicp_fast"):
        path = _config_file(tmp_path, base, f"icp_SynthICP_{name}",
                            MATRIX[name])
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(["train", "--config", path])
    assert not (tmp_path / "runs").exists()
