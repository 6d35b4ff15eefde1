"""Serving driver: closed-loop ``Aligner.align`` requests from one caller.

Traffic parameters (``benchmark/traffic/<mix>.json``):

- ``pool_seed``, ``pool_pairs``, ``rays``: the pool of scene pairs requests
  draw from (the same for every run seed, so that every seed sends the
  same clouds: the seed draws the requests, the resampling and the
  weights), and its scan resolution [vertical, horizontal];
- ``pairs``: pairs a request, ``{"fixed": n}`` or ``{"log_uniform": [lo,
  hi], "cycle": c}``: each cycle of ``c`` requests holds the rounded
  quantiles (j + 0.5) / c of the log-uniform law, in an order drawn from
  the seed, so that every seed sends the same sizes;
- ``resolve_flips``, ``refine_icp``, ``icp_its``, ``icp_radius``: the
  call's options;
- ``check_requests``: requests of the window compared with the reference
  (drawn from the seed; the one with the most pairs always among them).

Each request draws its pairs from the pool without replacement. The window
sends requests back to back until ``--seconds`` have passed; each request
is timed from call to return. The traced run continues the same stream for
``PROFILE_S`` seconds under the profiler.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from benchmark import harness, trace
from benchmark.counts import alignnet, nn_argmin as nn_count
from benchmark.inputs import pool as pool_mod
from benchmark.inputs import weights as weights_mod

PROFILE_S = 3.0
SLICE_S = 5.0     # the window's progress is logged at this step
TAU_LOGIT = 1e-3    # an argmax whose margin over the next bin is smaller
TAU_FLIP = 1e-4     # or a flip whose chamfer gap (relative) is smaller
# is decided by rounding: such a pair's answer is not compared (its
# count is printed); its centres still are. So is a pair whose reference
# answer (centres too) moves by more than SENS_TOL (m, rad) when its
# resampled points move by SENS_NOISE (m, one seeded gaussian draw): a
# DGCNN's kNN graph can swap a near-tied neighbour on such a change
SENS_NOISE = 1e-5
SENS_TOL = 1e-3
# ICP runs from the reference's own init; a pair whose reference ICP result
# moves by more than SENS_TOL when that init turns by any of ICP_NUDGES
# (rad about the origin, ICP's centre; five times the widest gap of a sound
# network pose, and a turn moves a scan's far points most) is decided by
# rounding too: from a random network's poses ICP can turn a last-bit
# difference of its start into another local minimum
ICP_NUDGES = (1e-4, -1e-4)


def request_sizes(spec: dict, rng: np.random.Generator):
    """Endless pairs-a-request stream."""
    if "fixed" in spec:
        while True:
            yield int(spec["fixed"])
    lo, hi = spec["log_uniform"]
    c = spec["cycle"]
    q = (np.arange(c) + 0.5) / c
    sizes = np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo))))
    while True:
        for k in rng.permutation(sizes):
            yield int(k)


def _port(cell, device, seed_w, seed_a):
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec

    cfg = {k: cell.config[k] for k in ("model", "training", "evaluation",
                                       "tpu")}
    spec = ModelSpec.from_config(config_from_dict(cfg))
    weights = weights_mod.seeded(cell.config["model"], seed_w, device)
    aligner = Aligner(spec, weights, batch_size=128,
                      scale_residuals=bool(cell.config["evaluation"].get(
                          "scale_residuals", False)),
                      seed=seed_a, device=device)
    harness.sync(device)
    return aligner, weights


def _counters(model):
    """{kernel: the port's wrapper with ``.launches``}: the backbone's
    serving kernels and ``nn_argmin`` (flips and ICP)."""
    from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin

    return {**harness.backbone(model["backbone"]).counters(train=False),
            "nn_argmin": nn_argmin}


def _request_work(model, k, clouds1, clouds2, t):
    """{kernel: [count args]} and model + nearest-neighbour dot FLOPs of
    one request of k pairs."""
    work = {name: list(calls) for name, calls in
            alignnet.kernel_calls(model, 128).items()}
    flops = alignnet.flops(model, k)  # the pairs asked for, not padding
    nn = []
    if t["resolve_flips"]:
        n = model["num_points"]
        nn += [(k, n, n, k * n)] * 2
    if t["refine_icp"]:
        n_max = min(max(len(c) for c in (*clouds1, *clouds2)), 4096)
        valid = sum(min(len(c), n_max) for c in clouds2)
        nn += [(k, n_max, n_max, valid)] * (t["icp_its"] + 1)
    if nn:
        work["nn_argmin"] = nn
        flops += sum(nn_count.count(*a)["dot_flops"] for a in nn)
    return work, flops


def run(ctx: harness.Run) -> harness.Result:
    t = ctx.cell.traffic
    with ctx.generation():
        pool = pool_mod.load_or_make(t["pool_seed"], 0, t["pool_pairs"],
                                     t["rays"], ctx.workers)
    ctx.mark("inputs made")
    model = ctx.cell.config["model"]
    seed_w, seed_a = ctx.seed_of(1), ctx.seed_of(2)
    req_rng = np.random.default_rng([ctx.seed, 3])
    sizes = request_sizes(t["pairs"], req_rng)
    kw = dict(resolve_flips=t["resolve_flips"], refine_icp=t["refine_icp"])
    if t["refine_icp"]:
        kw.update(icp_its=t["icp_its"], icp_radius=t["icp_radius"])
    aligner, weights = _port(ctx.cell, ctx.device, seed_w, seed_a)
    ctx.mark("weights made and folded")
    calls = []  # [(pair indices, outputs)] of every call, in order

    def call(k):
        idx = req_rng.choice(len(pool), k, replace=False)
        pcs1 = [pool[i][0] for i in idx]
        pcs2 = [pool[i][1] for i in idx]
        t0 = time.perf_counter()
        out = aligner.align(pcs1, pcs2, **kw)
        dt = time.perf_counter() - t0
        calls.append((idx, out))
        return dt, pcs1, pcs2

    largest = t["pairs"].get("fixed") or t["pairs"]["log_uniform"][1]
    for k in (largest, 1, largest):  # warm-up: every shape of a request
        call(k)
        harness.sync(ctx.device)
        ctx.mark(f"warm-up request of {k} pairs")
    first_window_call = len(calls)
    ctx.setup_done()

    lat, pairs, start = [], 0, time.perf_counter()
    slices, next_slice = [(0, 0, harness.host_marks())], start + SLICE_S
    while True:
        k = next(sizes)
        dt, _, _ = call(k)
        lat.append(dt)
        pairs += k
        now = time.perf_counter()
        if now >= next_slice:
            slices.append((len(lat), pairs, harness.host_marks()))
            next_slice += SLICE_S
        if now - start >= ctx.seconds:
            break
    window_s = time.perf_counter() - start
    for a, b in zip(slices, slices[1:]):
        harness.log(f"window slice of {SLICE_S:g} s: {b[0] - a[0]} "
                    f"requests, {b[1] - a[1]} pairs; "
                    f"{harness.host_load(a[2], b[2])}")
    window_calls = range(first_window_call, len(calls))
    peak = harness.memory_peak(ctx.device)
    harness.log(f"window {window_s:.3f} s: {len(lat)} requests, {pairs} "
                f"pairs")

    reading = {"latencies_s": lat, "pairs": pairs, "window_s": window_s}
    window = None
    if ctx.trace:
        counters = _counters(model)
        before = {n: f.launches for n, f in counters.items()}
        work, flops = {}, 0.0
        with trace.profiled(ctx.device) as held:
            t_end = time.perf_counter() + PROFILE_S
            while time.perf_counter() < t_end:
                k = next(sizes)
                with record_function("align"):
                    _, pcs1, pcs2 = call(k)
                w, f = _request_work(model, k, pcs1, pcs2, t)
                flops += f
                for name, args in w.items():
                    work.setdefault(name, []).extend(args)
        window = held.window
        launches = {n: f.launches - before[n] for n, f in counters.items()}
        reading.update(trace=window, work=work, launches=launches,
                       flops=flops)

    aligner = None  # the program's state goes before the reference runs
    bad = sum(1 for i in window_calls if not all(
        np.isfinite(v).all() for v in calls[i][1].values()))
    checks = _check(ctx, calls, window_calls, pool, weights, seed_a)
    return harness.Result(
        end_to_end={"offline_peak_gib": peak / 2 ** 30,
                    "track_p95_ms": float(np.percentile(lat, 95)) * 1e3},
        attempted=len(lat), failed=bad, memory_peak_bytes=peak,
        checks=checks, reading=reading, window=window)


def _angle_gap(a, b):
    return np.abs((np.asarray(a, np.float64) - b + np.pi) % (2 * np.pi)
                  - np.pi)


def _yaw(m):
    return np.arctan2(m[:, 1, 0], m[:, 0, 0])


def _tf_gap(m1, m2):
    """Per pair: the larger of the translation and yaw gaps of two (n, 4, 4)
    transforms."""
    return np.maximum(np.abs(m1[:, :3, 3] - m2[:, :3, 3]).max(1),
                      _angle_gap(_yaw(m1), _yaw(m2)))


def _pose_gap(t1, a1, c1, t2, a2, c2):
    """Per pair: the largest translation, yaw and centre gap."""
    return np.maximum.reduce([np.abs(t1 - t2).max(1), _angle_gap(a1, a2),
                              np.abs(c1 - c2).max(1)])


def nudged(init):
    """(1 + len(ICP_NUDGES)) stacked copies of (n, 4, 4) ICP inits: as
    they are, then each turned about z by one of ICP_NUDGES."""
    out = [init]
    for a in ICP_NUDGES:
        m = np.eye(4)
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = (np.cos(a), -np.sin(a),
                                              np.sin(a), np.cos(a))
        out.append(m @ init)
    return np.concatenate(out)


def reference_answers(model, inputs, traffic, scale, device,
                      nudge: bool = True) -> dict:
    """The plain reference's answers to one request (its replayed inputs):
    translations, angles, centres and which pairs rounding does not decide;
    with ICP the answers are the transforms ICP refines from the
    reference's own network poses, and, with ``nudge``, a pair whose ICP
    result moves by over SENS_TOL under one of ICP_NUDGES of its init is
    not decided."""
    from benchmark.reference import serve as ref

    a, b, flips = inputs["a"], inputs["b"], traffic["resolve_flips"]
    tr, an, ce, margins = ref.forward_decode(model, a, b, scale, flips,
                                             device)
    noise = np.random.default_rng(0).normal(0.0, SENS_NOISE, (2, *a.shape))
    moved = ref.forward_decode(model, (a + noise[0]).astype(np.float32),
                               (b + noise[1]).astype(np.float32), scale,
                               flips, device)
    stable = _pose_gap(moved[0], moved[1], moved[2], tr, an, ce) <= SENS_TOL
    decided = stable & (margins["logit"] >= TAU_LOGIT)
    if "flip" in margins:
        decided &= margins["flip"] >= TAU_FLIP
    out = {"translations": tr, "angles": an, "centers": ce,
           "decided": decided, "stable": stable}
    if traffic["refine_icp"]:
        init = ref.mat_angle(tr, an, ce)
        reps = 1 + len(ICP_NUDGES) if nudge else 1
        src, sm, dst, dm = (np.concatenate([inputs[k]] * reps) for k in
                            ("src", "src_mask", "dst", "dst_mask"))
        final = ref.icp(src, sm, dst, dm, nudged(init) if nudge else init,
                        traffic["icp_radius"], traffic["icp_its"], device)
        final = final.reshape(reps, len(init), 4, 4)
        out["translations"] = final[0, :, :3, 3]
        out["angles"] = _yaw(final[0])
        moved = np.max([_tf_gap(f, final[0]) for f in final], axis=0)
        out["icp_stable"] = moved <= SENS_TOL
        out["decided"] = decided & out["icp_stable"]
    return out


def gaps(answers: dict, ref: dict) -> dict:
    """Per-pair gaps of a request's answers to the reference's, in metres
    and radians, translation and yaw where the pair is decided (NaN where
    nothing of a pair is compared): with ICP ``icp_gap`` (the refined pose,
    which carries the network's, the flips' and ICP's errors), else
    ``net_gap`` (the network's pose, and its centres where the reference is
    stable)."""
    g = np.where(ref["decided"], np.maximum(
        np.abs(answers["translations"] - ref["translations"]).max(1),
        _angle_gap(answers["angles"], ref["angles"])), np.nan)
    if "icp_stable" in ref:
        return {"icp_gap": g}
    return {"net_gap": np.fmax(g, np.where(
        ref["stable"], np.abs(answers["centers"] - ref["centers"]).max(1),
        np.nan))}


def summarise(per_pair: dict) -> dict:
    """The numbers a cell's limits may hold, from {name: [per-pair gaps of
    a request]}: ``<name>`` the widest gap and ``<name>_p90`` the 90th
    percentile of the compared pairs' gaps (steady where near-ties that
    the rules above miss move a few pairs far)."""
    out = {}
    for name, parts in per_pair.items():
        v = np.concatenate(parts)
        v = v[np.isfinite(v)]
        out[name] = float(v.max(initial=0.0))
        out[f"{name}_p90"] = float(np.percentile(v, 90)) if len(v) else 0.0
    return out


def replayed(ctx, calls, pool, seed_a, sample):
    """(call index, pair indices, replayed inputs) of the sampled calls,
    the generator replayed over every call before them."""
    from benchmark.reference import serve as ref

    replay = ref.Replay(seed_a, ctx.cell.config["model"]["num_points"], 128)
    for i in range(max(sample) + 1):
        idx = calls[i][0]
        inputs = replay.call([pool[j][0] for j in idx],
                             [pool[j][1] for j in idx],
                             ctx.cell.traffic["refine_icp"])
        if i in sample:
            yield i, idx, inputs


def check_sample(ctx, calls, window_calls):
    """The calls compared: ``check_requests`` of the window drawn from the
    seed, and the one with the most pairs."""
    rng = np.random.default_rng([ctx.seed, 4])
    win = list(window_calls)
    sample = set(rng.choice(win, min(ctx.cell.traffic["check_requests"],
                                     len(win)), replace=False).tolist())
    sample.add(max(win, key=lambda i: len(calls[i][0])))
    return sample


def reference_model(ctx, weights):
    from benchmark.reference import model as ref_model

    cfg = ctx.cell.config
    scale = (np.pi / cfg["model"]["angles"]["num_bins"]
             if cfg["evaluation"].get("scale_residuals", False) else 1.0)
    return ref_model.Model(cfg["model"], weights), scale


def _check(ctx, calls, window_calls, pool, weights, seed_a):
    """Compare a seeded sample of the window's requests with the plain
    reference, after the program's state is freed; returns [(name, value,
    limit)]."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    model, scale = reference_model(ctx, weights)
    sample = check_sample(ctx, calls, window_calls)
    per_pair: dict = {}
    undecided = unstable = icp_unstable = total = 0
    t0 = time.perf_counter()
    for i, idx, inputs in replayed(ctx, calls, pool, seed_a, sample):
        ref = reference_answers(model, inputs, ctx.cell.traffic, scale,
                                ctx.device)
        for name, v in gaps(calls[i][1], ref).items():
            per_pair.setdefault(name, []).append(v)
        total += len(idx)
        undecided += int((~ref["decided"]).sum())
        unstable += int((~ref["stable"]).sum())
        icp_unstable += int((~np.asarray(ref.get("icp_stable", True))).sum())
    harness.log(f"reference: {len(sample)} requests, {total} pairs "
                f"({undecided} decided by rounding, of which {unstable} "
                f"moved by input noise and {icp_unstable} by an ICP nudge), "
                f"{time.perf_counter() - t0:.3f} s")
    readings = summarise(per_pair)
    for name, v in readings.items():
        harness.log(f"reading {name} {v!r}")
    lim = ctx.cell.limits
    return [(name, readings[name], lim[name]) for name in sorted(lim)]
