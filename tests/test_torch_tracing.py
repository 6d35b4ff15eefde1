"""The port's span and counter recorder (``alignnet3d_tpu_torch.tracing``)
and its sites on the CPU: off without a profiler (no ``record_function``,
no clock read, nothing recorded), and under a CPU ``torch.profiler`` every
span of a request with flips and ICP, of a training step and of the
prefetch iterator, with its parent, root and thread. No timings are
asserted: only counts, structure and the arithmetic of the aggregates."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alignnet3d_tpu_torch import tracing
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.provider import PrefetchIterator
from alignnet3d_tpu_torch.data.synthetic import generate_dataset
from alignnet3d_tpu_torch.models.alignnet import ModelSpec
from alignnet3d_tpu_torch.training.trainer import Trainer
from alignnet3d_tpu_torch.weights import init_state_dict

torch.set_num_threads(1)

SPEC = ModelSpec(num_points=32, num_bins=8, s1_backbone=(8, 16),
                 s1_mlp=(16,), s2_backbone=(8, 16), s2_mlp=(16,),
                 embedding=(8, 16), remaining_mlp=(16,))
# the request path's spans: once a request, and once a 128-pair chunk
PER_REQUEST = ("api.align", "api.icp_pad", "icp.run", "icp.upload",
               "icp.iterate", "icp.readback", "api.transforms")
PER_CHUNK = ("api.resample", "api.h2d", "serving.forward", "api.readback",
             "api.decode", "flips.resolve")
STAGES = ("trainer.to_device", "trainer.jitter", "trainer.forward",
          "trainer.loss", "trainer.backward", "trainer.optimizer")
BENCHMARK_SPANS = {"align", "train_step", "prefetch_wait"}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def aligner():
    return Aligner(SPEC, init_state_dict(SPEC, 0), seed=0, device="cpu")


def _clouds(k, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 300, 2 * k)
    clouds = [rng.normal(0, 1, (int(n), 3)).astype(np.float32)
              for n in sizes]
    return clouds[:k], clouds[k:]


def _request(aligner, k):
    pcs1, pcs2 = _clouds(k)
    return aligner.align(pcs1, pcs2, resolve_flips=True, refine_icp=True,
                         icp_its=2)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_without_a_profiler(aligner, monkeypatch):
    """No profiler: a span site is the shared no-op, enters no range,
    reads no clock, and the recorder stays empty."""
    def refuse(*args, **kwargs):
        raise AssertionError("touched while no profiler runs")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("api.align") is tracing.NO_SPAN
    assert tracing.span("anything") is tracing.NO_SPAN
    tracing.count("serving.rows", 128)
    out = _request(aligner, 3)
    assert np.isfinite(out["transforms"]).all()
    assert tracing.snapshot() == {"spans": {}, "counters": {},
                                  "records": []}


@pytest.mark.parametrize("k", [1, 5])
def test_a_request_records_every_span(aligner, k):
    _, prof = _profiled(lambda: _request(aligner, k))
    snap = tracing.snapshot()
    spans, records = snap["spans"], _by_name(snap["records"])
    for name in PER_REQUEST + PER_CHUNK:
        assert spans[name]["count"] == 1, name
    assert spans["icp.step"]["count"] == 2  # one an ICP iteration
    assert not BENCHMARK_SPANS & set(spans)
    for name, agg in spans.items():
        assert 0 <= agg["self_s"] <= agg["total_s"], name
    root = records["api.align"][0]
    assert root.parent is None and root.root == root.id
    for name in ("api.resample", "icp.iterate", "flips.resolve"):
        assert all(r.root == root.id for r in records[name]), name
    ids = {r.id: r.name for r in snap["records"]}
    assert ids[records["flips.resolve"][0].parent] == "api.decode"
    assert ids[records["icp.iterate"][0].parent] == "icp.run"
    assert {ids[r.parent] for r in records["icp.step"]} == {"icp.iterate"}
    assert ids[records["api.icp_pad"][0].parent] == "api.align"
    # ICP's steps; none fused on the CPU, where the update's plain
    # version runs
    assert snap["counters"] == {"serving.rows": 128,
                                "serving.padded_rows": 128 - k,
                                "icp.steps": 2}
    # every span is also a range on the profiler's own clock
    names = {e.name for e in prof.events()}
    assert set(PER_REQUEST + PER_CHUNK) <= names


def test_self_time_is_duration_less_direct_children():
    def nested():
        with tracing.span("outer"):
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    pass
            with tracing.span("inner"):
                pass

    _profiled(nested)
    snap = tracing.snapshot()
    recs = _by_name(snap["records"])

    def dur(r):
        return r.end_ns - r.start_ns

    outer, = recs["outer"]
    assert [r.parent for r in recs["inner"]] == [outer.id, outer.id]
    assert recs["leaf"][0].root == outer.id
    want_self = {
        "outer": dur(outer) - sum(dur(r) for r in recs["inner"]),
        "inner": sum(dur(r) for r in recs["inner"]) - dur(recs["leaf"][0]),
        "leaf": dur(recs["leaf"][0])}
    for name, ns in want_self.items():
        assert snap["spans"][name]["self_s"] == pytest.approx(ns / 1e9,
                                                              abs=1e-12)
        assert snap["spans"][name]["total_s"] == pytest.approx(
            sum(dur(r) for r in recs[name]) / 1e9, abs=1e-12)


def test_records_are_bounded_and_aggregates_are_not():
    rec = tracing.Recorder(maxlen=2)

    def three():
        for _ in range(3):
            with tracing._Span(rec, "s"):
                pass
        rec.count("c", 2)
        rec.count("c")

    _profiled(three)
    snap = rec.snapshot()
    assert len(snap["records"]) == 2 and snap["spans"]["s"]["count"] == 3
    assert snap["counters"] == {"c": 3}
    rec.reset()
    assert rec.snapshot() == {"spans": {}, "counters": {}, "records": []}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tracing_data"))
    generate_dataset(base, num_train=8, num_val=4, seed=2, vres=16, hres=180)
    return base


def test_a_training_step_records_its_stages(dataset, tmp_path):
    cfg = config_from_dict({
        "data": {"basepath": dataset},
        "logging": {"basedir": str(tmp_path), "logdir": str(tmp_path)},
        "model": {"num_points": 32, "options": {
            "s1transformer": [[8, 16], [[16], 0.7]],
            "s2transformer": [[8, 16], [[16], 0.7]],
            "embedding": [8, 16],
            "remaining_transform_prediction": [[16], 0.7]},
            "angles": {"num_bins": 8}},
        "training": {"batch_size": 4, "num_epochs": 1}})
    trainer = Trainer(cfg, seed=0, device="cpu")
    trainer.init_state()
    batch = trainer._make_batch(trainer.train_indices[:4])
    _profiled(lambda: trainer.train_step(batch))
    snap = tracing.snapshot()
    recs = _by_name(snap["records"])
    step, = recs["trainer.train_step"]
    assert step.parent is None
    for name in STAGES:
        r, = recs[name]
        assert r.parent == step.id and r.root == step.id, name
    assert set(snap["spans"]) == {"trainer.train_step", *STAGES}


def test_prefetch_spans_on_both_threads():
    def make(i):
        return np.full(3, i)

    def drain():
        it = PrefetchIterator(make, 3, prefetch=1)
        got = [int(b[0]) for b in it]
        it._thread.join(timeout=30)
        assert not it._thread.is_alive()
        return got

    got, _ = _profiled(drain)
    assert got == [0, 1, 2]
    recs = _by_name(tracing.snapshot()["records"])
    main = threading.get_ident()
    # three batches and the end of the stream
    assert len(recs["data.wait"]) == 4
    assert all(r.thread == main for r in recs["data.wait"])
    assert len(recs["data.assemble"]) == 3
    for r in recs["data.assemble"]:
        assert r.thread != main and r.parent is None and r.root == r.id
