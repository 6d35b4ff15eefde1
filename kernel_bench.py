#!/usr/bin/env python3
"""Times the port's two PointNet serving-path kernels (with ``--dgcnn``,
the two DGCNN serving kernels and the DGCNN forward; with ``--train``, the
fused training edge stage) on one CUDA card, optionally against another
checkout's build of them, in turns.

    python3 kernel_bench.py [--other DIR] [--sweep] [--ptxas] [--requests N]
                            [--dgcnn] [--train] [--out FILE]

From the root of a checkout. The inputs are ``chip_smoke.py``'s: the
stacked PointNet serving batch (256 clouds x 512 points) with the three
folded chains of ``configs/SynthCars.json`` (seeded random weights), and
``nn_argmin`` at the flip shape (128 x 512 x 512) and the ICP shape (128
pairs of up to 4096 points, prefix masks) from synthetic LiDAR pairs.
Every kernel is timed with CUDA events over repeated calls of its wrapper
and checked against its plain twin (``nn_argmin`` bit for bit).

- ``--other DIR``: another checkout (for example a ``git archive`` of an
  earlier commit) timed on the same card in the order other, this, this,
  other, each in a process of its own that imports that checkout's
  package and builds its kernels.
- ``--sweep``: also times ``nn_argmin``'s kernel under other column
  splits than its plan picks, and its pre-pass alone.
- ``--ptxas``: prints the registers, spills and shared memory that
  ``nvcc -Xptxas -v`` reports for the timed kernels' sources.
- ``--dgcnn``: also times ``knn_points`` (k=20) and ``fused_edge_stage``
  (the folded conv1/conv2 of the s1, s2 and embedding stacks of
  ``configs/SynthCars40kDGCNN.json``, seeded random weights) at the
  serving shape, 256 request clouds x 512 points over their kNN graph, as
  ``chip_smoke.py``'s kernel phases build them, each against its twin;
  and the folded DGCNN forward of 128 pairs (CUDA events).
- ``--requests N``: also times N rounds of ``chip_smoke.py``'s three
  PointNet requests of 128 pairs (plain, flips, flips + ICP) through
  ``Aligner.align``, on the host clock.
- ``--train``: also times ``fused_edge_stage_train`` at the training shape
  (the 256 request clouds resampled to 512 points, k=20 over their
  ``knn_points`` graph, C1=64, C2=128, seeded weights and cotangent):
  forward, forward + backward, the peak device memory of a call, and a
  ``torch.profiler`` breakdown of its device time by kernel; and the fused
  DGCNN training step at batch 128 on ``chip_smoke.py``'s generated
  dataset (host clock, peak memory), profiled the same way.

Prints one JSON line per run and, last, a JSON summary (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHAINS = ("s1", "s2", "embedding")
NN_SHAPES = ("flip", "icp")
SPIN_CYCLES = 400_000   # ~0.2 ms of spinning per timed call
# columns a sweep block visits, for the --sweep; None: all columns, one
# block a row strip (no merge)
SWEEP = {"flip": (None, 256, 128, 64), "icp": (None, 2048, 1024, 512, 256)}


def make_inputs(path: str) -> None:
    """chip_smoke.py's kernel inputs, as numpy arrays in one .npz file."""
    import chip_smoke as cs
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.serving import _fold_chain

    with open(cs.CONFIG) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))
    state = cs.seeded_weights(spec)
    requests = cs.make_requests()
    clouds = requests[0][0] + requests[0][1]
    rng = np.random.default_rng(cs.SEED)
    pts = np.stack([c[rng.integers(0, len(c), spec.num_points)] for c in clouds])
    arrays = {"x": (pts - pts.mean(axis=1, keepdims=True)).astype(np.float32)}
    prefixes = {"s1": ("siamese.transformer1.PointNetBackbone_0", spec.s1_backbone),
                "s2": ("siamese.transformer2.PointNetBackbone_0", spec.s2_backbone),
                "embedding": ("siamese.PointNetBackbone_0", spec.embedding)}
    for name, (prefix, widths) in prefixes.items():
        ws, bs = _fold_chain(state, prefix, len(widths), "cpu")
        for i, (w, b) in enumerate(zip(ws, bs)):
            arrays[f"{name}.w{i}"] = w.numpy()
            arrays[f"{name}.b{i}"] = b.numpy()
    for name, (src, dst, mask, _) in cs.nn_inputs(spec, *requests[2]).items():
        arrays.update({f"{name}.src": src, f"{name}.dst": dst,
                       f"{name}.mask": mask})
    # the requests' ragged clouds, concatenated, and the weights
    for r, sides in enumerate(requests):
        for side, pcs in zip("ab", sides):
            arrays[f"req{r}{side}.pts"] = np.concatenate(pcs).astype(np.float32)
            arrays[f"req{r}{side}.len"] = np.array([len(p) for p in pcs])
    arrays.update({f"state/{k}": v.numpy() for k, v in state.items()})
    # the training stage: 2 x PAIRS clouds of 512 points, seeded weights
    rng = np.random.default_rng(cs.SEED + 5)
    arrays["train.x"] = cs._resampled(clouds, 512, rng)
    for i, shape in enumerate(((6, 64), 64, 64, 64, (64, 128), 128, 128,
                               128)):
        scale = (0.4 if i == 0 else 1 / 8 if i == 4 else 0.1)
        centre = 1.0 if i in (2, 6) else 0.0
        arrays[f"train.p{i}"] = (centre + scale * rng.normal(size=shape)
                                 ).astype(np.float32)
    arrays["train.dout"] = rng.normal(size=(len(clouds), 512, 128)).astype(
        np.float32)
    # the DGCNN: chip_smoke.py's knn phase request set and the folded
    # conv1/conv2 of each stack; the forward's resampled pairs and weights
    with open(cs.DGCNN_CONFIG) as f:
        dspec = ModelSpec.from_config(config_from_dict(json.load(f)))
    dstate = cs.seeded_weights(dspec)
    arrays["dgcnn.x"] = cs._resampled(clouds, dspec.num_points,
                                      np.random.default_rng(cs.SEED + 3))
    for name, prefix in (("s1", "siamese.transformer1.DGCNNBackbone_0"),
                         ("s2", "siamese.transformer2.DGCNNBackbone_0"),
                         ("embedding", "siamese.DGCNNBackbone_0")):
        (w1, w2, _), (b1, b2, _) = _fold_chain(dstate, prefix, 3, "cpu")
        for key, val in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            arrays[f"dgcnn.{name}.{key}"] = val.numpy()
    rng = np.random.default_rng(cs.SEED + 7)
    for side, pcs in zip("ab", requests[0]):
        arrays[f"dgcnn.pair_{side}"] = np.stack(
            [c[rng.integers(0, len(c), dspec.num_points)] for c in pcs]
        ).astype(np.float32)
    arrays.update({f"dstate/{k}": v.numpy() for k, v in dstate.items()})
    np.savez(path, **arrays)


def time_requests(data, reps: int) -> dict:
    """Host-clock wall time of chip_smoke.py's three PointNet requests
    through Aligner.align, each ending in a synchronize: {kind: [ms]}."""
    import torch

    import chip_smoke as cs
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec

    with open(cs.CONFIG) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))
    state = {k[6:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("state/")}
    requests = []
    for r in range(len(cs.REQUESTS)):
        requests.append([np.split(data[f"req{r}{side}.pts"],
                                  np.cumsum(data[f"req{r}{side}.len"])[:-1])
                         for side in "ab"])
    aligner = Aligner(spec, state, batch_size=cs.PAIRS, seed=cs.SEED,
                      device="cuda")
    out = {}
    for rep in range(reps + 1):  # the first round warms every path up
        for (kind, kwargs), (pcs1, pcs2) in zip(cs.REQUESTS, requests):
            t0 = time.perf_counter()
            aligner.align(pcs1, pcs2, **kwargs)
            torch.cuda.synchronize()
            if rep:
                out.setdefault(kind, []).append(
                    (time.perf_counter() - t0) * 1e3)
    return out


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time on the card alone: the calls are enqueued while the card spins
    (torch.cuda._sleep, longer than the enqueueing), so they run back to
    back and the events see no host time between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_train(t) -> dict:
    """fused_edge_stage_train at the training shape: forward and forward +
    backward (CUDA events), the call's peak device memory above its inputs,
    and out against the twin."""
    import torch

    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops import knn_kernels as kk

    x, dout = t["train.x"], t["train.dout"]
    params = [t[f"train.p{i}"] for i in range(8)]
    idx = kk.knn_points(x, 20)

    def call():
        xs = x.clone().requires_grad_()
        ps = [p.clone().requires_grad_() for p in params]
        out, _ = et.fused_edge_stage_train(xs, idx, *ps)
        return torch.autograd.grad(out, [xs, *ps], dout)

    with torch.no_grad():
        out = et.fused_edge_stage_train(x, idx, *params)[0]
        ref = et.fused_edge_stage_train_plain(x, idx, *params)[0]
        fwd = cuda_ms(lambda: et.fused_edge_stage_train(x, idx, *params), 10)
    err = float((out - ref).abs().max())
    del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"fwd_ms": fwd, "fwd_bwd_ms": cuda_ms(call, 10),
            "peak_bytes": peak, "out_max_abs_err": err,
            "profile": device_breakdown(call, 5)}


def time_dgcnn(t, data) -> dict:
    """Kernels 3 and 4 at the DGCNN serving shape against their twins, and
    the folded DGCNN forward of 128 pairs, all with CUDA events."""
    import torch

    import chip_smoke as cs
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
    from alignnet3d_tpu_torch.ops import knn_kernels as kk

    x = t["dgcnn.x"]
    idx = kk.knn_points(x, 20)
    out = {"knn_points": {
        "bit_equal": bool(torch.equal(idx, kk.knn_points_plain(x, 20))),
        "ms": cuda_ms(lambda: kk.knn_points(x, 20), 50),
        "device_ms": device_ms(lambda: kk.knn_points(x, 20), 50)}}
    for name in CHAINS:
        args = (x, idx, *(t[f"dgcnn.{name}.{k}"]
                          for k in ("w1", "b1", "w2", "b2")))
        got = ek.fused_edge_stage(*args)
        err = float((got - ek.fused_edge_stage_plain(*args)).abs().max())
        out[f"fused_edge_stage {name}"] = {
            "ms": cuda_ms(lambda: ek.fused_edge_stage(*args), 20),
            "device_ms": device_ms(lambda: ek.fused_edge_stage(*args), 20),
            "max_abs_err": err}
    with open(cs.DGCNN_CONFIG) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))
    state = {k[7:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("dstate/")}
    aligner = Aligner(spec, state, batch_size=cs.PAIRS, seed=cs.SEED,
                      device="cuda")
    a, b = t["dgcnn.pair_a"], t["dgcnn.pair_b"]
    out["forward_ms"] = cuda_ms(lambda: aligner._forward(a, b), 20)
    return out


def device_breakdown(fn, reps: int) -> dict:
    """torch.profiler (CUPTI) over ``reps`` calls of ``fn``, ending in a
    synchronize: the host-clock ms a call (profiler overhead included), the
    device's busy ms a call (every kernel, copy and fill summed; one
    stream) and the 15 largest device ms a call by kernel name."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:60]
            by_name[name] = (by_name.get(name, 0.0)
                             + ev.time_range.elapsed_us() / 1e3 / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall, "device_busy_ms": sum(by_name.values()),
            "device_ms_by_kernel": dict(top)}


def time_step(basepath: str) -> dict:
    """One fused DGCNN training step at batch 128 (chip_smoke.py's config,
    dataset and batch): host-clock ms a step over 5 steps after a warm-up
    step, their peak device memory, and a profile of 3 steps."""
    import torch

    import chip_smoke as cs
    from alignnet3d_tpu_torch.training.trainer import Trainer

    logdir = tempfile.mkdtemp(dir=os.path.dirname(basepath))  # cleaned up
    cfg = cs.train_config(cs.TRAIN_CONFIG, basepath, logdir,
                          dgcnn_fused_train=True)
    trainer = Trainer(cfg, seed=cs.SEED, device="cuda")
    trainer.init_state()
    batch = trainer.dataset.sample_batch(trainer.train_indices[:cs.PAIRS],
                                         trainer.spec.num_points,
                                         np.random.default_rng(cs.SEED + 6))
    ms, peak = cs._step_ms(trainer, batch, steps=5)

    def step():
        trainer.train_step(batch)

    return {"step_ms": ms, "peak_bytes": peak,
            "profile": device_breakdown(step, 3)}


def run(root: str, inputs: str, sweep: bool, requests: int,
        train: bool = False, dgcnn: bool = False) -> dict:
    """Time the kernels of the checkout at ``root`` (imported from there)
    and, with ``requests`` > 0, that many rounds of the three requests.
    With ``train``, the training step reads the dataset that ``main`` made
    beside ``inputs``. With ``dgcnn``, the DGCNN serving kernels and
    forward."""
    sys.path.insert(0, root)
    import torch

    from alignnet3d_tpu_torch.ops import nn_kernels as nk
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    data = np.load(inputs)
    t = {k: torch.from_numpy(data[k]).cuda() for k in data.files}
    out = {"root": root, "pointnet": {}, "nn_argmin": {}, "sweep": {}}
    x = t["x"]
    for name in CHAINS:
        n_layers = sum(k.startswith(f"{name}.w") for k in t)
        ws = [t[f"{name}.w{i}"] for i in range(n_layers)]
        bs = [t[f"{name}.b{i}"] for i in range(n_layers)]
        got = pk.fused_pointnet(x, ws, bs)
        err = float((got - pk.fused_pointnet_plain(x, ws, bs)).abs().max())
        ms = cuda_ms(lambda: pk.fused_pointnet(x, ws, bs), iters=20)
        out["pointnet"][name] = {
            "ms": ms, "max_abs_err": err,
            "device_ms": device_ms(lambda: pk.fused_pointnet(x, ws, bs), 20)}
    for name in NN_SHAPES:
        src, dst, mask = (t[f"{name}.{k}"] for k in ("src", "dst", "mask"))
        idx, d2 = nk.nn_argmin(src, dst, mask)
        ri, rd = nk.nn_argmin_plain(src, dst, mask)
        equal = bool(torch.equal(idx, ri) and torch.equal(d2, rd))
        ms = cuda_ms(lambda: nk.nn_argmin(src, dst, mask),
                     iters=50 if name == "flip" else 20)
        out["nn_argmin"][name] = {
            "ms": ms, "bit_equal": equal,
            "device_ms": device_ms(lambda: nk.nn_argmin(src, dst, mask),
                                   iters=50 if name == "flip" else 20)}
        if sweep:
            n2p = -(-dst.shape[1] // nk.GROUP) * nk.GROUP
            for chunk in SWEEP[name]:
                chunk = chunk or n2p
                fn = lambda: nk.launch(src, dst, mask, chunk)  # noqa: E731
                si, sd = fn()
                ok = bool(torch.equal(si, ri) and torch.equal(sd, rd))
                out["sweep"][f"{name} chunk={chunk}"] = {
                    "device_ms": device_ms(fn, 50 if name == "flip" else 20),
                    "bit_equal": ok}
            out["sweep"][f"{name} column_table"] = {
                "device_ms": device_ms(lambda: nk.column_table(dst, mask), 50)}
    if dgcnn:
        out["dgcnn"] = time_dgcnn(t, data)
    if train:
        out["train"] = time_train(t)
        out["step"] = time_step(os.path.join(os.path.dirname(inputs), "data"))
    if requests:
        out["requests_ms"] = time_requests(data, requests)
    return out


def ptxas_report() -> None:
    """nvcc -Xptxas -v of the timed kernels' sources, compiled on their
    own."""
    from alignnet3d_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as work:
        for name in ("nn_argmin", "fused_pointnet", "edge_train",
                     "knn_points", "edge_stage"):
            src = _build.CSRC_DIR / f"{name}.cu"
            proc = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(src), "-o", os.path.join(work, f"{name}.o")],
                capture_output=True, text=True)
            for line in (proc.stdout + proc.stderr).splitlines():
                if proc.returncode or any(
                        w in line for w in ("registers", "spill", "Compiling")):
                    print(f"ptxas {name}: {line.strip()}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="another checkout, timed in turns")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--requests", type=int, default=0, metavar="N",
                        help="also time N rounds of chip_smoke.py's three "
                        "PointNet requests (host clock)")
    parser.add_argument("--dgcnn", action="store_true",
                        help="also time knn_points, fused_edge_stage and "
                        "the folded DGCNN forward")
    parser.add_argument("--train", action="store_true",
                        help="also time fused_edge_stage_train and the "
                        "fused DGCNN training step")
    parser.add_argument("--out", help="also write the summary here")
    parser.add_argument("--run", nargs=2, metavar=("ROOT", "INPUTS"),
                        help=argparse.SUPPRESS)  # one timed process
    args = parser.parse_args()
    if args.run:
        print(json.dumps(run(*args.run, sweep=args.sweep,
                             requests=args.requests, train=args.train,
                             dgcnn=args.dgcnn)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    if args.ptxas:
        ptxas_report()
    this = str(ROOT)
    order = [this, this]
    if args.other:
        other = str(Path(args.other).resolve())
        order = [other, this, this, other]
    runs = []
    with tempfile.TemporaryDirectory() as work:
        inputs = os.path.join(work, "inputs.npz")
        make_inputs(inputs)
        if args.train:
            import chip_smoke as cs

            cs.make_dataset(os.path.join(work, "data"))
        for i, root in enumerate(order):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--run", root,
                   inputs]
            if args.sweep and root == this and i == 1:
                cmd.append("--sweep")
            cmd += ["--requests", str(args.requests)]
            if args.train:
                cmd.append("--train")
            if args.dgcnn:
                cmd.append("--dgcnn")
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]))
    summary = {"card": card, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
