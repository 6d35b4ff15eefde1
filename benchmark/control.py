"""Readings of the comparison's control and planted faults, at a cell's
own sizes: what the limits in ``benchmark/limits/`` are set against.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \
        [--stand-in tf32|tf32_dense|half_batch]

For each seed the cell's inputs and the sample of requests (or the first
training steps) are built as a run builds them, and the plain reference in
float32 is compared, by the cell's own numbers, with a stand-in for the
program: the reference with TF32 products (``tf32``, the control), with
TF32 in its dense products alone (``tf32_dense``: distances, and so the
kNN graph and nearest neighbours, stay float32), or, for a training cell
(``half_batch``), the reference stepping on the first half of each batch's
rows. The benchmark's runs never call this.
Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def serve_readings(ctx, control: str = "tf32") -> dict:
    import numpy as np

    from benchmark.drivers import serve
    from benchmark.inputs import pool as pool_mod
    from benchmark.inputs import weights as weights_mod
    from benchmark.reference import model as ref_model

    t = ctx.cell.traffic
    with ctx.generation():
        pool = pool_mod.load_or_make(t["pool_seed"], 0, t["pool_pairs"],
                                     t["rays"], ctx.workers)
    req_rng = np.random.default_rng([ctx.seed, 3])
    sizes = serve.request_sizes(t["pairs"], req_rng)
    largest = t["pairs"].get("fixed") or t["pairs"]["log_uniform"][1]
    ks = [largest, 1, largest] + [next(sizes) for _ in
                                  range(4 * t["check_requests"])]
    calls = [(req_rng.choice(len(pool), k, replace=False), None) for k in ks]
    weights = weights_mod.seeded(ctx.cell.config["model"], ctx.seed_of(1),
                                 ctx.device)
    model, scale = serve.reference_model(ctx, weights)
    sample = serve.check_sample(ctx, calls, range(3, len(calls)))
    per_pair: dict = {}
    for _, _, inputs in serve.replayed(ctx, calls, pool, ctx.seed_of(2),
                                       sample):
        with ref_model.precision(control):
            ctl = serve.reference_answers(model, inputs, t, scale, ctx.device,
                                          nudge=False)
        ref = serve.reference_answers(model, inputs, t, scale, ctx.device)
        for name, v in serve.gaps(ctl, ref).items():
            per_pair.setdefault(name, []).append(v)
    return serve.summarise(per_pair)


def train_readings(ctx, stand_in: str = "tf32") -> dict:
    import numpy as np

    from benchmark.drivers import train
    from benchmark.inputs import pool as pool_mod
    from benchmark.inputs import weights as weights_mod

    conf = ctx.cell.config
    bs = conf["training"]["batch_size"]
    with ctx.generation():
        scenes = pool_mod.load_or_make(
            ctx.seed, 1, conf["train_pairs"] + conf["val_pairs"],
            conf["scan_rays"], ctx.workers, cache=False)
    stream = train.index_stream(ctx.seed, conf["train_pairs"])
    steps = ctx.cell.traffic["check_steps"]
    batches = [np.asarray([next(stream) for _ in range(bs)])
               for _ in range(steps)]
    weights = weights_mod.seeded(conf["model"], ctx.seed_of(1), ctx.device)
    seed = ctx.seed_of(6) >> 2
    ref = train.reference_steps(ctx, weights, scenes, batches, seed)
    if stand_in == "half_batch":
        other = train.reference_steps(ctx, weights, scenes,
                                      [b[:bs // 2] for b in batches], seed)
    else:
        other = train.reference_steps(ctx, weights, scenes, batches, seed,
                                      control=stand_in)
    return train.gaps(other, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-in", choices=("tf32", "tf32_dense",
                                            "half_batch"), default="tf32")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        ctx = harness.Run(cell=cell, seed=seed, seconds=0, trace=False,
                          workers=min(8, os.cpu_count() or 1))
        if cell.traffic["driver"] == "train":
            readings = train_readings(ctx, args.stand_in)
        else:
            readings = serve_readings(ctx, args.stand_in)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "stand_in": args.stand_in,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
