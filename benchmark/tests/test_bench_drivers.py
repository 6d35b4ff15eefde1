"""One tiny run of each driver on the CPU, called directly (not through
``benchmark.run``), and ``benchmark.run`` on a machine with no card."""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import cpu_run, tiny


@pytest.mark.parametrize("name", ["pointnet-track", "pointnet-offline",
                                  "dgcnn-offline", "dgcnn-train",
                                  "pointnet-train"])
def test_driver_runs_tiny_on_the_cpu(name):
    cell = tiny(name)
    run = cpu_run(cell, trace=True)
    result = harness.driver(cell).run(run)
    assert run.setup_s is not None and run.setup_s > 0
    assert result.attempted >= 1 and result.failed == 0
    assert {n for n, _, _ in result.checks} == set(cell.limits)
    assert harness.is_correct(result), result.checks
    for m in cell.end_to_end:  # no device memory is counted on the CPU
        if m["name"] != "setup_s":
            value = result.end_to_end[m["name"]]
            assert math.isfinite(value) and (value > 0 or m["unit"] == "GiB")
    for m in cell.per_layer:  # device readings are absent on the CPU
        value = harness.reader(m["name"])(result.reading)
        assert value is None or (math.isfinite(value) and value > 0)
    assert result.window is not None and result.window.window_s > 0


def test_run_without_a_card_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "pointnet-offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.gpu
def test_a_cell_on_the_card(card):
    import json

    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "pointnet-offline", "--seed", "3", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
