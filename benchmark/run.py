"""Run one benchmark cell of the PyTorch port on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Builds the cell's inputs from the seed, sets
up the port (counted as ``setup_s``, input generation left out), measures
for ``--seconds``, checks what the timed calls returned against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics and the
device's busy time in a profiled window (``--trace 1``). Exits non-zero and
prints no result without enough CUDA cards, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

CACHE = Path(__file__).resolve().parent / ".cache"


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))

    from benchmark import harness

    run_started = harness.process_start_time()
    cell = harness.find_cell(args.workload)
    import torch

    harness.log(f"set-up {time.time() - run_started:.3f} s: torch imported")
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s): cuda available "
                    f"{torch.cuda.is_available()}, "
                    f"{torch.cuda.device_count()} found; no result")
        return 2
    harness.log(f"card: {_card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), started=run_started,
                      workers=min(8, os.cpu_count() or 1))
    result = harness.driver(cell).run(run)

    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded modules of JAX or the JAX package: {found}; "
                    f"no result")
        return 3
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in result.checks}
    correct = harness.is_correct(result)
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = harness.reader(m["name"])(result.reading)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**result.end_to_end, "setup_s": run.setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": result.memory_peak_bytes}
    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics, "device": device}
    if args.trace and result.window is not None:
        w = result.window
        device["busy_s"] = w.busy_s
        device["window_s"] = w.window_s
        line["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in sorted(
                w.kernel_s.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n[:160], s] for n, s in w.idle_gaps[:10]]}
    line["checks"] = checks
    harness.log(f"setup_s {run.setup_s:.3f} (input generation "
                f"{run.generation_s:.3f} s apart); correct {correct}")
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
