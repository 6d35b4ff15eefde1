"""The benchmark's data-driven core: what a cell is made of, found by name.

- ``BENCHMARK.json`` (the repo root): cells (``workloads``), configurations
  and metrics;
- ``benchmark/configs/<config>.json``: a configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: a traffic mix, parameters for the
  driver it names (``benchmark/drivers/<driver>.py``: ``run(ctx)``);
- ``benchmark/limits/<cell>.json``: the limits of the cell's comparison
  with the plain reference;
- ``benchmark/layer_metrics/<metric>.py``: a per-layer metric's reader,
  ``read(reading)`` returning a number or None (nothing to read).

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here names one.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alignnet3d_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell listed under its
    ``workloads``; an end-to-end metric without the key (``setup_s``) is
    reported in every cell. A per-layer metric has to list its cells."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        raise ValueError(f"per-layer metric {metric['name']!r} lists no "
                         f"workloads")
    return True


def find_cell(name: str, spec: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    spec = load_spec(bench_dir.parent) if spec is None else spec
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    return Cell(
        name=name, workload=work,
        config=_json(bench_dir.parent / conf["file"]),
        traffic=_json(bench_dir / "traffic" / f"{work['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"]
                    if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def driver(cell: Cell):
    return importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    path = bench_dir / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.layer_metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Result:
    """What a driver returns."""
    end_to_end: dict                 # metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list                     # [(name, value, limit)]
    reading: dict = field(default_factory=dict)  # what readers read
    window: object = None            # trace.Window of the traced run


@dataclass
class Run:
    """A run's arguments and clocks, handed to the traffic's driver."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    workers: int = 8
    started: float = field(default_factory=process_start_time)
    generation_s: float = 0.0
    setup_s: float | None = None

    @contextlib.contextmanager
    def generation(self):
        """Input generation: timed apart and left out of ``setup_s``."""
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.generation_s += dt
        log(f"input generation {dt:.3f} s (not set-up)")

    def mark(self, what: str):
        """Log the set-up time so far (input generation left out)."""
        log(f"set-up {time.time() - self.started - self.generation_s:.3f} s:"
            f" {what}")

    def setup_done(self):
        """Called when the measured window starts."""
        self.setup_s = time.time() - self.started - self.generation_s

    def seed_of(self, *tags: int) -> int:
        """A 62-bit seed derived from the run seed and ``tags``."""
        import numpy as np

        ss = np.random.SeedSequence([int(self.seed), *tags])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))


def host_marks():
    """(wall s, this process's user CPU s, its system CPU s) now."""
    t = os.times()
    return time.perf_counter(), t.user, t.system


def host_load(a, b) -> str:
    """This process's CPU between two ``host_marks``, in cores."""
    wall = max(b[0] - a[0], 1e-9)
    return (f"user {(b[1] - a[1]) / wall:.2f} cores, "
            f"system {(b[2] - a[2]) / wall:.2f}")


def sync(device: str):
    """Wait for the device (nothing to wait for on the CPU)."""
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    """The device's peak allocated bytes (0 on the CPU)."""
    if str(device).startswith("cuda"):
        import torch

        return int(torch.cuda.max_memory_allocated())
    return 0


def is_correct(result: Result) -> bool:
    """Every compared number within its limit, and no failed request."""
    return bool(result.checks) and result.failed == 0 and all(
        value <= limit for _, value, limit in result.checks)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
