"""The benchmark's readers of the port's own spans and counters
(``benchmark/layer_metrics/_spans.py`` and the eight metrics over it): the
number each gives from a hand-built recorder state, nothing from an empty
one or from a program without a recorder, each found by name through the
harness, each listed only in cells that report what it moves, and a
finite reading after a real request and a real prefetched batch under a
CPU profiler."""

import math
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alignnet3d_tpu_torch import tracing
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.data.provider import PrefetchIterator
from alignnet3d_tpu_torch.models.alignnet import ModelSpec
from alignnet3d_tpu_torch.weights import init_state_dict
from benchmark import harness

torch.set_num_threads(1)


def _agg(count, total_s, self_s):
    return {"count": count, "total_s": total_s, "self_s": self_s}


STATE = {
    "spans": {
        "api.align": _agg(4, 0.400, 0.010),
        "api.resample": _agg(4, 0.060, 0.040),
        "api.icp_pad": _agg(4, 0.030, 0.020),
        "icp.run": _agg(4, 0.080, 0.008),
        "trainer.train_step": _agg(5, 0.450, 0.050),
        "data.assemble": _agg(6, 0.012, 0.012),
    },
    "counters": {"serving.rows": 512, "serving.padded_rows": 448,
                 "icp.steps": 120, "icp.fused_steps": 90},
    "records": [],
}
# metric -> (its value from STATE, the spans and counters it needs)
EXPECTED = {
    "api.resample_ms.track": (10.0, ("api.resample", "api.align")),
    "api.resample_ms.offline": (10.0, ("api.resample", "api.align")),
    "api.icp_pad_ms.track": (5.0, ("api.icp_pad", "api.align")),
    "icp.ms.track": (20.0, ("icp.run", "api.align")),
    "serving.padded_pct.track": (87.5, ("serving.padded_rows",
                                        "serving.rows")),
    "trainer.host_ms.train": (90.0, ("trainer.train_step",)),
    "data.assemble_ms.train": (2.0, ("data.assemble",)),
    "icp.fused_step_pct.track": (75.0, ("icp.fused_steps", "icp.steps")),
}
# where a metric's number comes from, when not the host clock
SOURCES = {"icp.fused_step_pct.track": "program_counter"}
SPEC = harness.load_spec()
ENTRIES = {m["name"]: m for m in SPEC["per_layer"]}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_recorder(name, monkeypatch):
    read = harness.reader(name)
    want, needs = EXPECTED[name]
    monkeypatch.setattr(tracing, "snapshot", lambda: STATE)
    assert read({}) == pytest.approx(want, rel=1e-12)
    for missing in needs:  # any span or counter absent: nothing to read
        state = {k: {n: v for n, v in STATE[k].items() if n != missing}
                 for k in ("spans", "counters")}
        monkeypatch.setattr(tracing, "snapshot", lambda s=state: s)
        assert read({}) is None, missing


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_from_an_empty_recorder(name):
    assert tracing.snapshot()["spans"] == {}
    assert harness.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_a_recorder(name, monkeypatch):
    """A program that keeps no recorder (an older checkout) reads as
    nothing and raises nothing."""
    monkeypatch.setitem(sys.modules, "alignnet3d_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["alignnet3d_tpu_torch"], "tracing")
    assert harness.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_entry_lists_cells_that_report_what_it_moves(name):
    entry = ENTRIES[name]
    assert entry["source"] == SOURCES.get(name, "host_clock")
    moved = next(e for e in SPEC["end_to_end"] if e["name"] == entry["moves"])
    cells = {w["name"] for w in SPEC["workloads"]}
    assert entry["workloads"] and set(entry["workloads"]) <= cells
    assert all(harness.reports(moved, c) for c in entry["workloads"])
    for cell in entry["workloads"]:
        assert name in {m["name"] for m in harness.find_cell(cell).per_layer}


def test_readers_read_a_traced_request_and_batch():
    """Every reader but the training step's (tests/test_torch_tracing.py
    holds that span) reads a request and a prefetched batch; the share of
    fused ICP steps reads nothing on the CPU, where no step is fused."""
    spec = ModelSpec(num_points=32, num_bins=8, s1_backbone=(8, 16),
                     s1_mlp=(16,), s2_backbone=(8, 16), s2_mlp=(16,),
                     embedding=(8, 16), remaining_mlp=(16,))
    aligner = Aligner(spec, init_state_dict(spec, 1), seed=1, device="cpu")
    rng = np.random.default_rng(1)
    clouds = [rng.normal(0, 1, (int(n), 3)).astype(np.float32)
              for n in rng.integers(40, 200, 8)]
    with profile(activities=[ProfilerActivity.CPU]):
        aligner.align(clouds[:4], clouds[4:], resolve_flips=True,
                      refine_icp=True, icp_its=2)
        list(PrefetchIterator(lambda i: np.zeros(3), 2, prefetch=1))
    on_card = {"trainer.host_ms.train", "icp.fused_step_pct.track"}
    for name in sorted(set(EXPECTED) - on_card):
        value = harness.reader(name)({})
        assert value is not None and math.isfinite(value) and value > 0, name
    assert tracing.snapshot()["counters"]["icp.steps"] == 2
    assert harness.reader("icp.fused_step_pct.track")({}) is None
    assert harness.reader("serving.padded_pct.track")({}) == pytest.approx(
        100.0 * 124 / 128)
