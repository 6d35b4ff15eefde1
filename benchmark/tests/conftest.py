"""Tiny versions of the benchmark's cells, for runs on the CPU."""

from __future__ import annotations

import copy

import pytest

from benchmark import harness
from benchmark.inputs import pool as pool_mod

TINY_TRAFFIC = {
    "track": {"pool_pairs": 6, "rays": [16, 360],
              "pairs": {"log_uniform": [3, 6], "cycle": 4},
              "check_requests": 2, "icp_its": 3},
    "offline": {"pool_pairs": 6, "rays": [16, 360], "pairs": {"fixed": 5},
                "check_requests": 2},
    "train": {},
}


def tiny(name: str) -> harness.Cell:
    """The cell of BENCHMARK.json at a size the CPU runs in seconds: a few
    low-resolution scenes, small requests, 3 ICP iterations; for training
    16 pairs, batch 4 and 32 points a cloud."""
    cell = harness.find_cell(name)
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.workload["traffic"]]}
    if cell.traffic["driver"] == "train":
        conf = copy.deepcopy(cell.config)
        conf.update(train_pairs=16, val_pairs=2, scan_rays=[16, 180])
        conf["training"]["batch_size"] = 4
        conf["model"]["num_points"] = 32
        cell.config = conf
    return cell


def cpu_run(cell: harness.Cell, seed: int = 123456789012,
            seconds: float = 0.5, trace: bool = False) -> harness.Run:
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                       device="cpu", workers=2)


@pytest.fixture(autouse=True)
def _pool_cache(tmp_path, monkeypatch):
    """Input pools go to the test's own directory, not the checkout's."""
    monkeypatch.setattr(pool_mod, "CACHE_DIR", tmp_path / "cache")


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
