"""Every backbone-dependent piece of the benchmark comes from one module
and one plain reference per backbone, found by the configuration's
``model.backbone``: the seeded weights, the counts and the reference
forward read the same as before the lookup (digests and counts pinned
from the harness that named its two backbones itself), and a backbone
added as two new files is found with no file of the benchmark edited."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil

import pytest
import torch

from benchmark import harness
from benchmark.counts import alignnet
from benchmark.inputs import weights
from benchmark.reference import model as ref_model

CONFIGS = ["pointnet-synthcars", "dgcnn-synthcars40k"]
# sha256 of the state-dict keys (one a line) and of the values' bytes in
# key order, at seed 0 on the CPU
KEYS = {"pointnet-synthcars": (96, "4eab3ec7f90a98dc569355130701aa091e24"
                                   "9b41816b35c1bb6d32c5a0d98519"),
        "dgcnn-synthcars40k": (96, "d9c2891737c306069ae672bfd6485572bb14"
                                   "21fd8ca5d4971b5c3b691658879a")}
VALUES = {"pointnet-synthcars": "dec6a3d756a6341245830a8f56cb95f9d7bd524a1"
                                "bad4b3d82a23f40ade79774",
          "dgcnn-synthcars40k": "cef08a6e4010c598505aefafe5c4e663df862c3f9"
                                "78c925dd279d3b36f5a9207"}
# sha256 of the reference forward's outputs (sorted by name) at 64 points,
# 3 pairs of seeded clouds, eval and train mode, one thread
FORWARD = {("pointnet-synthcars", False): "1386d8a9c102d02e709493d2af3393"
                                          "2dd23e5a7a918cd4b5a0c268c6627c7660",
           ("pointnet-synthcars", True): "27b508c6b688f890b7eed378307ccd"
                                         "dac7a7c8d39360efcdeb0906c02913515c",
           ("dgcnn-synthcars40k", False): "cadb322391db1a3663b19722c82cad"
                                          "3094e1c91f8a4958aedb8777577e76cc9c",
           ("dgcnn-synthcars40k", True): "a866d48b66ae87b9491d576e7669d4"
                                         "7d8a69ac4160f857613f38b32a41799430"}
STACKS = [(3, 64, 128, 256), (3, 64, 128, 512), (3, 64, 128, 1024)]


def _model(config):
    return json.loads((harness.BENCH_DIR / "configs" /
                       f"{config}.json").read_text())["model"]


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _forward(model, sd, train, bench_dir=harness.BENCH_DIR):
    g = torch.Generator().manual_seed(7)
    a = torch.randn(3, 64, 3, generator=g)
    b = torch.randn(3, 64, 3, generator=g)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            return ref_model.Model(model, sd, bench_dir).forward(
                a, b, train=train)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("config", CONFIGS)
def test_seeded_weights_are_pinned(config):
    sd = weights.seeded(_model(config), 0, "cpu")
    keys = list(sd)
    n, digest = KEYS[config]
    assert len(keys) == n
    assert hashlib.sha256("\n".join(keys).encode()).hexdigest() == digest
    assert _digest(sd[k] for k in keys) == VALUES[config]


@pytest.mark.parametrize("config,train", [(c, t) for c in CONFIGS
                                          for t in (False, True)])
def test_reference_forward_is_pinned(config, train):
    model = {**_model(config), "num_points": 64}
    out = _forward(model, weights.seeded(model, 0, "cpu"), train)
    assert _digest(out[k] for k in sorted(out)) == FORWARD[config, train]


def test_counts_are_pinned():
    pointnet, dgcnn = _model(CONFIGS[0]), _model(CONFIGS[1])
    assert alignnet.flops(pointnet, 1) == 526_415_360
    assert alignnet.flops(pointnet, 128, train=True) == 202_143_498_240
    assert alignnet.flops(dgcnn, 1) == 1_493_333_504
    assert alignnet.flops(dgcnn, 128, train=True) == 571_024_146_432
    assert alignnet.kernel_calls(pointnet, 128) == {
        "fused_pointnet": [(256, 512, s) for s in STACKS]}
    assert alignnet.kernel_calls(dgcnn, 128) == {
        "knn_points": [(256, 512, 20)] * 3,
        "fused_edge_stage": [(256, 512, 20, 64, 128)] * 3}
    assert alignnet.kernel_calls(dgcnn, 128, train=True) == {
        "knn_points": [(256, 512, 20)] * 3,
        "fused_edge_stage_train": [(256, 512, 20, 3, 64, 128)] * 3}
    # PointNet's training step runs nn.Linear and batch norm eagerly
    assert alignnet.kernel_calls(pointnet, 128, train=True) == {}


@pytest.mark.parametrize("config", CONFIGS)
def test_counters_cover_the_kernel_calls(config):
    """Each kernel a backbone counts has the port's launch counter."""
    model = _model(config)
    bb = harness.backbone(model["backbone"])
    for train in (False, True):
        calls = alignnet.kernel_calls(model, 2, train=train)
        counters = bb.counters(train)
        assert set(calls) == set(counters)
        assert all(isinstance(c.launches, int) for c in counters.values())


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_backbone_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a backbone, a PointNet under another
    module name, as two new files; its weights, counts and reference
    forward are then found through the lookup, and nothing is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _files(bench)
    src = (bench / "backbones" / "pointnet.py").read_text()
    (bench / "backbones" / "toy.py").write_text(
        src.replace('"PointNetBackbone_0"', '"ToyBackbone_0"'))
    shutil.copy(bench / "reference" / "backbones" / "pointnet.py",
                bench / "reference" / "backbones" / "toy.py")
    after = _files(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        k.relative_to(bench) for k in (bench / "backbones" / "toy.py",
                                       bench / "reference" / "backbones"
                                       / "toy.py")}

    pointnet = {**_model("pointnet-synthcars"), "num_points": 64}
    toy = copy.deepcopy(pointnet)
    toy["backbone"] = "toy"
    assert harness.backbone("toy", bench).MODULE == "ToyBackbone_0"
    sd = weights.seeded(pointnet, 0, "cpu")
    sd_toy = weights.seeded(toy, 0, "cpu", bench_dir=bench)
    assert list(sd_toy) == [k.replace("PointNetBackbone_0", "ToyBackbone_0")
                            for k in sd]
    assert all(torch.equal(a, b) for a, b in zip(sd.values(),
                                                 sd_toy.values()))
    for train in (False, True):
        assert alignnet.flops(toy, 4, train, bench_dir=bench) == \
            alignnet.flops(pointnet, 4, train)
        assert alignnet.kernel_calls(toy, 4, train, bench_dir=bench) == \
            alignnet.kernel_calls(pointnet, 4, train)
        out = _forward(pointnet, sd, train)
        out_toy = _forward(toy, sd_toy, train, bench)
        assert all(torch.equal(out[k], out_toy[k]) for k in out)


def test_an_unknown_backbone_names_the_missing_file(tmp_path):
    with pytest.raises(KeyError, match=r"backbones/nope\.py"):
        harness.backbone("nope")
    with pytest.raises(KeyError, match=r"reference/backbones/nope\.py"):
        harness.reference_backbone("nope")
    model = {**_model("pointnet-synthcars"), "backbone": "nope"}
    with pytest.raises(KeyError, match=r"backbones/nope\.py"):
        weights.layout(model)
