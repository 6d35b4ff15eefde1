"""Training driver: ``Trainer.train_step`` back to back, fed by the port's
``PrefetchIterator`` over ``PackedDataset.sample_batch``.

Traffic parameters: ``prefetch`` (batches the iterator holds ahead) and
``check_steps`` (the first steps, compared with the reference). The
configuration gives the dataset (``train_pairs``, ``val_pairs`` scenes at
``scan_rays``), written in the dataset layout under ``TMPDIR`` and removed
at the end, the batch size and the optimizer.

Set-up builds one ``Trainer``, loads the seeded weights, and drives it
through its first ``check_steps`` steps by the window's own feed: these
are the steps the reference follows (losses, the first gradient as Adam
holds it, the parameters after them). The window then goes on with the
same object and the same iterator, with no synchronize a step; the losses
are read back once after it, and a non-finite one fails the run. The index
stream is a seeded permutation of the training split, drawn anew each time
it wraps.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
from torch.profiler import record_function

from benchmark import harness, trace
from benchmark.counts import alignnet
from benchmark.inputs import pool as pool_mod
from benchmark.inputs import scenes as scenes_mod
from benchmark.inputs import weights as weights_mod

PROFILE_S = 3.0
ADAM_BETA1 = 0.9


class _Stop(Exception):
    """Ends the prefetch thread after the window."""


def index_stream(seed: int, train: int):
    rng = np.random.default_rng([seed, 5])
    while True:
        yield from rng.permutation(train)


def port_config(config: dict, basepath: str, logdir: str) -> dict:
    cfg = {k: config[k] for k in ("model", "training", "evaluation", "tpu")}
    cfg["data"] = {"basepath": basepath}
    cfg["logging"] = {"basedir": logdir, "logdir": logdir}
    return cfg


def run(ctx: harness.Run) -> harness.Result:
    cell, t = ctx.cell, ctx.cell.traffic
    conf = cell.config
    bs = conf["training"]["batch_size"]
    n_train = conf["train_pairs"]
    work_dir = tempfile.mkdtemp(prefix="bench-train-")
    try:
        with ctx.generation():
            scenes = pool_mod.load_or_make(
                ctx.seed, 1, n_train + conf["val_pairs"], conf["scan_rays"],
                ctx.workers, cache=False)
            basepath = os.path.join(work_dir, "data")
            scenes_mod.write_dataset(basepath, scenes, n_train)
        return _run(ctx, t, conf, bs, scenes, basepath, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def _run(ctx, t, conf, bs, scenes, basepath, work_dir):
    import torch
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.data import provider
    from alignnet3d_tpu_torch.training.trainer import Trainer

    ctx.mark("inputs made")
    weights = weights_mod.seeded(conf["model"], ctx.seed_of(1), ctx.device)
    ctx.mark("weights made")
    trainer_seed = ctx.seed_of(6) >> 2
    cfg = config_from_dict(port_config(conf, basepath,
                                       os.path.join(work_dir, "run")))
    trainer = Trainer(cfg, seed=trainer_seed, device=ctx.device)
    trainer.init_state()
    trainer.model.load_state_dict(weights)
    if trainer._residual_params is not None:
        raise ValueError("the training cell runs no residual task")
    ctx.mark("trainer built (dataset packed)")

    stream = index_stream(ctx.seed, conf["train_pairs"])
    batches = []  # the index batches in feed order
    data_rng = np.random.default_rng([ctx.seed, 7])
    stop = []

    def make(i):
        if stop:
            raise _Stop
        idx = np.asarray([next(stream) for _ in range(bs)], np.int64)
        batches.append(idx)
        return trainer.dataset.sample_batch(idx, conf["model"]["num_points"],
                                            data_rng)

    feed = provider.PrefetchIterator(make, 1 << 30, t["prefetch"])
    params = dict(trainer.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in params.items()}
    losses, first_grads = [], None
    for _ in range(t["check_steps"]):
        losses.append(trainer.train_step(next(feed))["losses/loss"])
        harness.sync(ctx.device)
        ctx.mark(f"step {len(losses)}")
        if first_grads is None:  # Adam's first moment is (1 - b1) g
            state = trainer.optimizer.state
            first_grads = {k: state[p]["exp_avg"].detach().clone()
                           / (1 - ADAM_BETA1) for k, p in params.items()}
    p_after = {k: p.detach().clone() for k, p in params.items()}
    check_losses = [float(x) for x in losses]
    harness.sync(ctx.device)
    if str(ctx.device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_done()

    steps, wait, window_losses = 0, [], []
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        w0 = time.perf_counter()
        batch = next(feed)
        wait.append(time.perf_counter() - w0)
        window_losses.append(trainer.train_step(batch)["losses/loss"])
        steps += 1
    harness.sync(ctx.device)
    window_s = time.perf_counter() - start
    peak = harness.memory_peak(ctx.device)
    harness.log(f"window {window_s:.3f} s: {steps} steps")

    reading = {"window_s": window_s, "steps": steps, "wait_s": wait}
    window = None
    if ctx.trace:
        from alignnet3d_tpu_torch.ops.edge_train_kernels import (
            fused_edge_stage_train)

        before = fused_edge_stage_train.launches
        traced = 0
        with trace.profiled(ctx.device) as held:
            t_end = time.perf_counter() + PROFILE_S
            while time.perf_counter() < t_end:
                with record_function("prefetch_wait"):
                    batch = next(feed)
                with record_function("train_step"):
                    window_losses.append(
                        trainer.train_step(batch)["losses/loss"])
                traced += 1
        window = held.window
        calls = alignnet.kernel_calls(conf["model"], bs, train=True)
        reading.update(
            trace=window, flops=traced * alignnet.flops(conf["model"], bs,
                                                        train=True),
            work={k: v * traced for k, v in calls.items()},
            launches={"fused_edge_stage_train":
                      fused_edge_stage_train.launches - before})

    stop.append(True)
    try:  # the thread ends at its next batch
        for _ in feed:
            pass
    except _Stop:
        pass
    values = torch.stack(window_losses).cpu().numpy()
    failed = int((~np.isfinite(values)).sum())
    program = {"losses": check_losses,
               "grads": {k: v.float() for k, v in first_grads.items()},
               "change": {k: (p_after[k] - p0[k]).float() for k in p0}}
    trainer = feed = params = None  # the program's state goes first
    checks = check(ctx, program, weights, scenes, batches, trainer_seed)
    return harness.Result(
        end_to_end={"train_step_ms": window_s / steps * 1e3,
                    "train_peak_gib": peak / 2 ** 30},
        attempted=steps, failed=failed, memory_peak_bytes=peak,
        checks=checks, reading=reading, window=window)


def _norms(tree: dict) -> dict:
    return {k: float(np.linalg.norm(v.detach().cpu().double().numpy()))
            for k, v in tree.items()}


def gaps(program: dict, reference: dict) -> dict:
    """The numbers that can be compared: the relative loss gap of the first
    step and of the worst step; by the worst leaf, the gap of the first
    gradient's norm and of the change's norm, each against the larger of
    the reference leaf's norm and the median leaf's. Leaves whose
    reference gradient is under a thousandth of the median leaf's (biases
    a batch norm absorbs) are left out of the change. The cell's limits
    name the numbers compared."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"],
                                               reference["losses"])]
    gp, gr = _norms(program["grads"]), _norms(reference["grads"])
    g_med = float(np.median(list(gr.values())))
    grad = max(abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr)
    cp, cr = _norms(program["change"]), _norms(reference["change"])
    moved = [k for k in cr if gr[k] >= 1e-3 * g_med]
    c_med = float(np.median([cr[k] for k in moved]))
    change = [abs(cp[k] - cr[k]) / max(cr[k], c_med) for k in moved]
    worst_g = max(gr, key=lambda k: abs(gp[k] - gr[k]) / max(gr[k], g_med))
    worst_c = moved[int(np.argmax(change))]
    harness.log(f"worst gradient leaf {worst_g} ({gp[worst_g]!r} vs "
                f"{gr[worst_g]!r}, median {g_med!r}); worst change leaf "
                f"{worst_c} ({cp[worst_c]!r} vs {cr[worst_c]!r}, median "
                f"{c_med!r}); {len(gr) - len(moved)} leaves left out")
    return {"loss_gap": max(rel), "loss1_gap": rel[0], "grad_gap": grad,
            "update_gap": max(change)}


def reference_steps(ctx, weights, scenes, batches, trainer_seed,
                    control: str | None = None) -> dict:
    from benchmark.reference import model as ref_model
    from benchmark.reference import train as ref_train

    conf = ctx.cell.config
    steps = ctx.cell.traffic["check_steps"]
    with ref_model.precision(control or "float32"):
        losses, grads, params = ref_train.first_steps(
            conf, weights, scenes, batches[:steps],
            np.random.default_rng([ctx.seed, 7]), trainer_seed, ctx.device,
            steps)
    return {"losses": losses, "grads": grads,
            "change": {k: params[k] - weights[k] for k in params}}


def check(ctx, program, weights, scenes, batches, trainer_seed):
    import gc

    import torch

    gc.collect()
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_steps(ctx, weights, scenes, batches, trainer_seed)
    g = gaps(program, ref)
    harness.log(f"reference: {len(ref['losses'])} steps, losses "
                f"{ref['losses']} (program {program['losses']}), "
                f"{time.perf_counter() - t0:.3f} s")
    for name, v in g.items():
        harness.log(f"reading {name} {v!r}")
    lim = ctx.cell.limits
    return [(name, g[name], lim[name]) for name in sorted(lim)]
