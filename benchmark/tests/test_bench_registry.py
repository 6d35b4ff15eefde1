"""BENCHMARK.json's shape and limits, every piece of every cell
found by name, and a new cell added from files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_per_layer_metrics_list_their_cells():
    """Every per-layer metric lists the cells that report it, each of which
    reports the end-to-end metric it moves; only an end-to-end metric may
    leave its cells out (then every cell reports it)."""
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert all(harness.reports(moved, c) for c in m["workloads"])
    bare = {k: v for k, v in SPEC["per_layer"][0].items() if k != "workloads"}
    with pytest.raises(ValueError):
        harness.reports(bare, CELLS[0])
    setup = next(e for e in SPEC["end_to_end"] if e["name"] == "setup_s")
    assert all(harness.reports(setup, c) for c in CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.find_cell(name)
    assert cell.workload["chips"] == 1
    assert harness.driver(cell).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    assert cell.limits


def test_configs_hold_what_is_run():
    for conf in SPEC["configs"]:
        data = json.loads((harness.ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"]
        for key in conf["reduced"]:
            assert key in data
            assert key in data["published"] or key in data["assumed"]
        assert {"model", "training", "evaluation", "tpu"} <= set(data)


def test_a_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix, its limits and
    a per-layer metric by new files and new entries; nothing is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (bench / "traffic" / "offline8.json").write_text(json.dumps(
        {**json.loads((bench / "traffic" / "offline.json").read_text()),
         "pairs": {"fixed": 8}}))
    (bench / "limits" / "pointnet-offline8.json").write_text(
        json.dumps({"net_gap": 3e-4}))
    (bench / "layer_metrics" / "requests.offline8.py").write_text(
        "def read(reading):\n    return float(len(reading['latencies_s']))\n")
    spec["workloads"].append({"name": "pointnet-offline8",
                              "config": "pointnet-synthcars",
                              "traffic": "offline8", "chips": 1,
                              "why": "8-pair requests"})
    spec["per_layer"].append({"name": "requests.offline8", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "api", "moves": "offline_peak_gib",
                              "workloads": ["pointnet-offline8"]})
    next(m for m in spec["end_to_end"] if m["name"] == "offline_peak_gib")[
        "workloads"].append("pointnet-offline8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell("pointnet-offline8", spec, bench_dir=bench)
    assert cell.traffic["pairs"] == {"fixed": 8}
    assert [m["name"] for m in cell.per_layer] == ["requests.offline8"]
    assert harness.reader("requests.offline8", bench)(
        {"latencies_s": [0.1, 0.2]}) == 2.0
    assert harness.driver(cell).__name__ == "benchmark.drivers.serve"
