#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90).

    python3 chip_smoke.py

From the root of a checkout, with nothing built beforehand:

1. checks for a Hopper card and prints its name and power limit;
2. builds the CUDA kernels from ``alignnet3d_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch twin at the shapes the
   serving paths give it, timing both with CUDA events;
4. serves 3 requests of 128 synthetic LiDAR pairs through
   ``Aligner.align`` at the full width of ``configs/SynthCars.json``
   (PointNet, seeded random weights), counting every kernel launch;
5. serves 2 requests of 128 pairs (plain, flips) at the full width of
   ``configs/SynthCars40kDGCNN.json`` (DGCNN), counting launches anew;
6. sends the same requests through the port on the CPU, where it runs the
   twins, and compares the answers;
7. generates a synthetic dataset (3 x 128 training and 128 validation
   pairs) and holds the fused training edge stage against its twin at the
   training shape, forward and backward, and its gradients against
   float64 on the branch (relu masks, max slots) it took;
8. trains one epoch (3 steps + the dual eval) of the DGCNN of
   ``configs/SynthCars40kDGCNNFusedR4.json`` with ``dgcnn_fused_train`` on,
   through ``Trainer.train()``, counting launches, and compares its first
   step with the unfused path's from the same weights and batch, the edge
   layers also under the same cotangent;
9. trains one epoch of the PointNet of ``configs/SynthCars.json``;
10. prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

Any failed phase exits non-zero without the last line. So does a machine
without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "SynthCars.json"
DGCNN_CONFIG = ROOT / "configs" / "SynthCars40kDGCNN.json"
TRAIN_CONFIG = ROOT / "configs" / "SynthCars40kDGCNNFusedR4.json"
DATA_SHARDS = 8            # worker processes of the dataset generator
SHARD_TRAIN, SHARD_VAL = 48, 16   # pairs per shard: 384 train, 128 val
SEED = 0
PAIRS = 128       # pairs per request, one serving batch
REQUESTS = (      # (name, align kwargs)
    ("plain", {}),
    ("flips", {"resolve_flips": True}),
    ("flips+icp", {"resolve_flips": True, "refine_icp": True}),
)
DGCNN_REQUESTS = (  # no ICP: that path is the PointNet requests'
    ("dgcnn plain", {}),
    ("dgcnn flips", {"resolve_flips": True}),
)
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, and device memory
FP32_FLOPS = 67e12
FP32_LANE_OPS = FP32_FLOPS / 2   # an FMA counts as two FLOPs
HBM_BYTES = 3.35e12
EDGE_TOL = 1e-5          # edge stage vs twin: summation order over C1
NET_ATOL = 1e-3          # network-only answers, card vs CPU
TIE_MARGIN = 1e-3        # a decision this close is settled by rounding
# The DGCNN's kNN graph is a discontinuous function of its input: a
# rounding-level change can swap the k-th neighbour and move a max. A pair
# whose CPU answer moves by more than NET_ATOL when every input coordinate
# is perturbed by SENS_REL relative noise (~16 f32 ulps; SENS_DRAWS seeded
# draws) is settled by rounding too, and at most SENS_SHARE of a
# request's pairs may be.
SENS_REL = 1e-6
SENS_DRAWS = 3
SENS_SHARE = 0.10
ICP_TOL = (0.01, 0.1)    # m, degrees
ICP_AGREE = 0.95         # share of ICP pairs within ICP_TOL
TRAIN_TOL = 1e-4         # edge-train kernel vs twin: out and stats (rtol;
TRAIN_ATOL = 1e-5        # atol); each gradient's relative L2 error from
#                          float64 on the kernel's own branch (its relu
#                          masks and slots), where no rounding flip counts
TIE_ABS = 1e-5           # a branch float64 does not take lies this near a tie
STEP_LOSS_RTOL = 1e-5    # fused vs unfused first training step: the loss
STEP_GRAD_TOL = 1e-3     # and each parameter gradient's relative L2 error;
#                          the edge layers' gradients under one cotangent
# The first step's loss and gradients hang on discrete choices (the yaw
# bins' argmax, the max over points) that rounding can flip. The fused and
# unfused paths round differently, so beyond the tolerances above their gap
# is held to STEP_SENS_FACTOR times the largest gap of the unfused path
# under STEP_SENS_DRAWS draws of a STEP_SENS_REL relative perturbation of
# its input points (~2 f32 ulps). The edge layers that kernel 5 replaces
# are held to STEP_GRAD_TOL alone, with the cotangent fixed.
STEP_SENS_REL = 1e-7
STEP_SENS_DRAWS = 3
STEP_SENS_FACTOR = 2.0
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def _scene_clouds(seed: int):
    from alignnet3d_tpu_torch.data.synthetic import SyntheticBoxScene

    scene = SyntheticBoxScene(seed)
    scene.generate_pointcloud()
    return scene.pointclouds


def make_requests():
    """3 x PAIRS ragged LiDAR pairs from seeded scenes, generated in worker
    processes (a full-resolution scene takes ~0.4 s of numpy)."""
    needed = len(REQUESTS) * PAIRS
    seeds = range(SEED * 100_000, SEED * 100_000 + needed + needed // 16)
    ctx = multiprocessing.get_context("spawn")
    # one BLAS thread per worker: the workers inherit this environment
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
    try:
        with concurrent.futures.ProcessPoolExecutor(8, mp_context=ctx) as pool:
            scenes = [c for c in pool.map(_scene_clouds, seeds, chunksize=8)
                      if min(len(p) for p in c) >= 5]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(len(scenes) >= len(REQUESTS) * PAIRS, "too few non-empty scenes")
    return [([c[0] for c in scenes[r * PAIRS:(r + 1) * PAIRS]],
             [c[1] for c in scenes[r * PAIRS:(r + 1) * PAIRS]])
            for r in range(len(REQUESTS))]


def seeded_weights(spec):
    """Port-native seeded init, with the BN statistics and affine drawn at
    random so that folding them changes every layer."""
    from alignnet3d_tpu_torch.weights import init_state_dict

    state = init_state_dict(spec, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)

    def draw(t, lo, hi):
        return lo + (hi - lo) * torch.rand(t.shape, generator=gen)

    for key, t in state.items():
        leaf = key.rsplit(".", 2)
        if not leaf[-2].startswith("bn"):
            continue
        if leaf[-1] in ("scale", "var"):
            state[key] = draw(t, 0.5, 2.0)
        else:  # bias, mean
            state[key] = draw(t, -0.2, 0.2)
    return state


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def bound(ops: float, op_rate: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card needs for ``ops``
    operations at ``op_rate`` and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = ops / op_rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_pointnet_phase(spec, state, clouds):
    """Kernel 1 against its twin on the three folded chains, f32 and bf16,
    at the stacked serving batch (2 x PAIRS clouds of N points)."""
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk
    from alignnet3d_tpu_torch.serving import _fold_chain

    rng = np.random.default_rng(SEED)
    n = spec.num_points
    pts = np.stack([c[rng.integers(0, len(c), n)] for c in clouds])
    x = torch.from_numpy(pts - pts.mean(axis=1, keepdims=True)).cuda()
    chains = {
        "s1": ("siamese.transformer1.PointNetBackbone_0", spec.s1_backbone),
        "s2": ("siamese.transformer2.PointNetBackbone_0", spec.s2_backbone),
        "embedding": ("siamese.PointNetBackbone_0", spec.embedding),
    }
    result = {}
    for name, (prefix, widths) in chains.items():
        ws, bs = _fold_chain(state, prefix, len(widths), "cuda")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            got = pk.fused_pointnet(x, ws, bs, dtype)
            ref = pk.fused_pointnet_plain(x, ws, bs, dtype)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, rtol=tol, atol=tol)
            ms = cuda_ms(lambda: pk.fused_pointnet(x, ws, bs, dtype))
            plain_ms = cuda_ms(lambda: pk.fused_pointnet_plain(x, ws, bs, dtype))
            dims = "-".join(str(d) for d in (3, *widths))
            print(f"fused_pointnet {name} {dims} B={x.shape[0]} N={n} "
                  f"{str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(ok, f"fused_pointnet {name} {dtype} disagrees with its twin")
            # f32 operands on the FP32 pipes; bytes: points, weights, output
            flops = 2 * x.shape[0] * n * sum(
                int(w.shape[0] * w.shape[1]) for w in ws)
            nbytes = 4 * (x.numel() + sum(w.numel() + b.numel()
                                          for w, b in zip(ws, bs))
                          + x.shape[0] * widths[-1])
            result[(name, dtype)] = (err, ms, plain_ms,
                                     *bound(flops, FP32_FLOPS, nbytes))
    return result


def _ragged(clouds, n_max, rng):
    arr = np.zeros((len(clouds), n_max, 3), np.float32)
    msk = np.zeros((len(clouds), n_max), bool)
    for i, pc in enumerate(clouds):
        if len(pc) > n_max:
            pc = pc[rng.choice(len(pc), n_max, replace=False)]
        arr[i, :len(pc)] = pc
        msk[i, :len(pc)] = True
    return arr, msk


def nn_argmin_phase(spec, pcs1, pcs2):
    """Kernel 2 against its twin at the flip shape (PAIRS x N, full masks)
    and the ICP shape (PAIRS x up to 4096 points, ragged masks)."""
    from alignnet3d_tpu_torch.ops import nn_kernels as nk

    rng = np.random.default_rng(SEED + 2)
    n = spec.num_points
    flip = [np.stack([c[rng.integers(0, len(c), n)] for c in pcs])
            for pcs in (pcs1, pcs2)]
    a1, m1 = _ragged(pcs1, 4096, rng)
    a2, m2 = _ragged(pcs2, 4096, rng)
    full = np.ones(flip[1].shape[:2], bool)
    cases = {  # name: (src, dst, dst mask, src mask)
        "flip": (flip[0], flip[1], full, full),
        "icp": (a1, a2, m2, m1),
    }
    result = {}
    for name, (src, dst, mask, src_mask) in cases.items():
        src, dst, mask = (torch.from_numpy(v).cuda() for v in (src, dst, mask))
        idx, d2 = nk.nn_argmin(src, dst, mask)
        ri, rd = nk.nn_argmin_plain(src, dst, mask)
        torch.cuda.synchronize()
        diff = (idx != ri).nonzero()
        check(len(diff) <= 1000, f"nn_argmin {name}: {len(diff)} indices "
              "differ from the twin")
        # a differing index is allowed only where the two candidates' exact
        # distances tie within 1e-5 (1 + d2)
        bad = 0
        for b, i in diff.tolist():
            a = src[b, i].double()
            dk = float(((dst[b, idx[b, i]].double() - a) ** 2).sum())
            dt = float(((dst[b, ri[b, i]].double() - a) ** 2).sum())
            bad += abs(dk - dt) > 1e-5 * (1.0 + dt)
        d2_ok = torch.allclose(d2, rd, rtol=1e-5, atol=1e-6)
        err = float((d2 - rd).abs().max())
        ms = cuda_ms(lambda: nk.nn_argmin(src, dst, mask))
        plain_ms = cuda_ms(lambda: nk.nn_argmin_plain(src, dst, mask), iters=3)
        print(f"nn_argmin {name} B={src.shape[0]} n1={src.shape[1]} "
              f"n2={dst.shape[1]} valid={int(mask.sum())}: "
              f"idx differ {len(diff)} (not ties: {bad}), "
              f"bit-equal={bool(torch.equal(idx, ri) and torch.equal(d2, rd))}, "
              f"d2 max_abs_err={err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        check(bad == 0 and d2_ok, f"nn_argmin {name} disagrees with its twin")
        # ~9 FP32 lane operations per pair this data needs: valid source
        # points x valid destination points
        pairs = float((src_mask.sum(1).astype(np.float64)
                       * mask.sum(1).cpu().numpy()).sum())
        nbytes = (src.numel() + dst.numel()) * 4 + mask.numel() + idx.numel() * 12
        result[name] = (err, ms, plain_ms,
                        *bound(9 * pairs, FP32_LANE_OPS, nbytes))
    return result


def _resampled(clouds, n, rng):
    """Centred clouds of n points drawn with replacement, as the serving
    resampler draws them: a cloud of few points has many exact copies."""
    pts = np.stack([c[rng.integers(0, len(c), n)] for c in clouds])
    return np.ascontiguousarray(pts - pts.mean(axis=1, keepdims=True),
                                np.float32)


def knn_points_phase(spec, clouds):
    """Kernel 3 against its twin at the stacked serving batch (2 x PAIRS
    clouds of N points, k=20): the resampled request clouds and a seeded
    normal set. Indices must be bit-equal, or differ only at a proven tie
    (equal float64 distances). Returns the request graph and the result."""
    from alignnet3d_tpu_torch.ops import knn_kernels as kk

    rng = np.random.default_rng(SEED + 3)
    n, k = spec.num_points, 20
    sets = {
        "requests": _resampled(clouds, n, rng),
        "normal": (rng.normal(size=(len(clouds), n, 3)) * 3.0).astype(np.float32),
    }
    result = {}
    for name, pts in sets.items():
        x = torch.from_numpy(pts).cuda()
        idx = kk.knn_points(x, k)
        ref = kk.knn_points_plain(x, k)
        torch.cuda.synchronize()
        # float64 distances of the chosen neighbours, kernel and twin
        x64 = x.double()
        d_k = ((torch.gather(x64[:, None].expand(-1, n, -1, -1), 2,
                             idx[..., None].expand(-1, -1, -1, 3))
                - x64[:, :, None]) ** 2).sum(-1)
        d_t = ((torch.gather(x64[:, None].expand(-1, n, -1, -1), 2,
                             ref[..., None].expand(-1, -1, -1, 3))
                - x64[:, :, None]) ** 2).sum(-1)
        differ = idx != ref
        err = float((d_k - d_t).abs().max())
        not_tie = differ & ((d_k - d_t).abs() > 1e-5 * (1.0 + d_t))
        dup = float((d_t[..., 1:] == d_t[..., :-1]).double().mean())
        ms = cuda_ms(lambda: kk.knn_points(x, k))
        plain_ms = cuda_ms(lambda: kk.knn_points_plain(x, k), iters=3)
        print(f"knn_points {name} B={x.shape[0]} N={n} k={k}: "
              f"bit-equal={bool(torch.equal(idx, ref))}, idx differ "
              f"{int(differ.sum())} (not ties: {int(not_tie.sum())}), "
              f"tied neighbour slots {dup:.1%}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        check(not bool(not_tie.any()),
              f"knn_points {name} disagrees with its twin")
        # ~9 FP32 lane operations per (query, candidate) pair; bytes:
        # points in, int64 indices out
        b = x.shape[0]
        result[name] = (err, ms, plain_ms,
                        *bound(9.0 * b * n * n, FP32_LANE_OPS,
                               x.numel() * 4 + idx.numel() * 8))
        if name == "requests":
            graph = (x, idx)
    return graph, result


def fused_edge_stage_phase(spec, state, graph):
    """Kernel 4 against its twin on the folded conv1/conv2 of the s1, s2
    and embedding stacks, over the request graph of the kNN phase."""
    from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
    from alignnet3d_tpu_torch.serving import _fold_chain

    x, idx = graph
    stacks = {
        "s1": ("siamese.transformer1.DGCNNBackbone_0", spec.s1_backbone),
        "s2": ("siamese.transformer2.DGCNNBackbone_0", spec.s2_backbone),
        "embedding": ("siamese.DGCNNBackbone_0", spec.embedding),
    }
    result = {}
    for name, (prefix, widths) in stacks.items():
        (w1, w2, _), (b1, b2, _) = _fold_chain(state, prefix, 3, "cuda")
        args = (x, idx, w1, b1, w2, b2)
        got = ek.fused_edge_stage(*args)
        ref = ek.fused_edge_stage_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = torch.allclose(got, ref, rtol=EDGE_TOL, atol=EDGE_TOL)
        ms = cuda_ms(lambda: ek.fused_edge_stage(*args))
        plain_ms = cuda_ms(lambda: ek.fused_edge_stage_plain(*args), iters=3)
        b, n, k = idx.shape
        c1, c2 = int(w2.shape[0]), int(w2.shape[1])
        print(f"fused_edge_stage {name} conv1/conv2 {2 * x.shape[-1]}-{c1}-{c2}"
              f" B={b} N={n} k={k}: max_abs_err={err:.3e} (tol {EDGE_TOL}) "
              f"max |out| {float(ref.abs().max()):.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        check(ok, f"fused_edge_stage {name} disagrees with its twin")
        # the k x C1 x C2 product per point on the FP32 pipes (the U/V
        # products add 2 x 2 x 3 x C1 per point); bytes: U, V, idx, out
        flops = 2.0 * b * n * (k * c1 * c2 + 2 * x.shape[-1] * c1)
        nbytes = 4 * b * n * (2 * c1 + c2) + idx.numel() * 8
        result[name] = (err, ms, plain_ms,
                        *bound(flops, FP32_FLOPS, nbytes))
    return result


def _dataset_shard(args):
    """One shard of the training dataset, by the port's generator."""
    from alignnet3d_tpu_torch.data.synthetic import generate_dataset

    path, shard = args
    generate_dataset(path, SHARD_TRAIN, SHARD_VAL, seed=SEED * 1000 + shard)
    return path


def make_dataset(basepath: str):
    """DATA_SHARDS shards generated in worker processes, merged into one
    dataset directory (train indices first, then val)."""
    shards = [(os.path.join(basepath, f"shard{i}"), i)
              for i in range(DATA_SHARDS)]
    ctx = multiprocessing.get_context("spawn")
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
    try:
        with concurrent.futures.ProcessPoolExecutor(
                DATA_SHARDS, mp_context=ctx) as pool:
            paths = list(pool.map(_dataset_shard, shards))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for sub in ("meta", "pointcloud1", "pointcloud2", "split"):
        os.makedirs(os.path.join(basepath, sub), exist_ok=True)
    splits = {"train": [], "val": []}
    n = 0
    for split, per in (("train", SHARD_TRAIN), ("val", SHARD_VAL)):
        for path in paths:
            with open(os.path.join(path, "split", f"{split}.txt")) as f:
                idxs = [int(x) for x in f.read().split()]
            check(len(idxs) == per, f"dataset shard {path}: {len(idxs)} "
                  f"{split} pairs")
            for i in idxs:
                for sub, ext in (("meta", "json"), ("pointcloud1", "npy"),
                                 ("pointcloud2", "npy")):
                    os.replace(os.path.join(path, sub, f"{i:08d}.{ext}"),
                               os.path.join(basepath, sub, f"{n:08d}.{ext}"))
                splits[split].append(n)
                n += 1
    for split, idxs in splits.items():
        with open(os.path.join(basepath, "split", f"{split}.txt"), "w") as f:
            f.write("\n".join(str(i) for i in idxs) + "\n")
    for path in paths:
        shutil.rmtree(path)
    return splits


def train_config(path: Path, basepath: str, logdir: str, **options):
    """The config at ``path`` for one epoch on the generated dataset, with
    ``model.options`` overridden by ``options``."""
    from alignnet3d_tpu_torch.config import config_from_dict

    with open(path) as f:
        d = json.load(f)
    d["data"]["basepath"] = basepath
    d["logging"] = {"basedir": logdir, "logdir": logdir}
    d["model"]["options"].update(options)
    d["training"]["num_epochs"] = 1
    return config_from_dict(d)


def _absorbed_biases(names):
    """conv{i}/fc{i} biases of the model with a bn{i} after them."""
    out = {}
    for name in names:
        head, _, leaf = name.rpartition(".")
        parent, _, layer = head.rpartition(".")
        if leaf == "bias" and layer[:-1] in ("conv", "fc"):
            bn = f"{parent}.bn{layer[-1]}.bias"
            if bn in names:
                out[name] = bn
    return out


def _gathered(v, idx):
    """Row idx[b, i, t] of v's cloud b, for every edge: (B, N, k, C)."""
    bsz, n, c = v.shape
    rows = (idx + (torch.arange(bsz, device=idx.device) * n)[:, None, None])
    return v.reshape(bsz * n, c).index_select(0, rows.reshape(-1)).reshape(
        *idx.shape, c)


def _edge_bn_outputs(x, idx, params, mask1=None):
    """(y1, y2): BN1(pre1) and BN2(pre2) of every edge before their relus,
    by the twin's operations in x's dtype (the twin's own values in f32).
    ``mask1`` given, h1 is y1 where it is true and 0 elsewhere, in place of
    relu(y1)."""
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops.edge_conv_kernels import _split

    w1, b1, g1, be1, w2, b2, g2, be2 = params
    u, v = _split(x, w1, b1)
    y1 = et._batch_norm_train(u[:, :, None, :] + _gathered(v, idx), g1, be1,
                              et.EPS)[0]
    h1 = torch.relu(y1) if mask1 is None else torch.where(mask1, y1, 0.0)
    pre2 = torch.matmul(h1, w2) + b2
    return y1, et._batch_norm_train(pre2, g2, be2, et.EPS)[0]


def _kernel_mask1(u, v, bn1, idx):
    """The kernel's first-layer relu mask, rebuilt from its saved U, V and
    (mu1, r1, g1, be1) table: pre1 and xhat1 = (pre1 - mu1) r1 are its f32
    operations, and h1 = fmaf(xhat1, g1, be1) > 0 has the sign of the exact
    value, taken in float64. Also the mask had it rounded the product
    before the add."""
    xh = (u[:, :, None, :] + _gathered(v, idx) - bn1[0]) * bn1[1]
    fused = xh.double() * bn1[2].double() + bn1[3].double() > 0
    return fused, xh * bn1[2] + bn1[3] > 0


def _branch_grads(x, idx, params, dout, mask1, slot, live):
    """The stage's gradients in float64 on one branch: the first layer's
    relu mask, the max's slots and the output's relu mask fixed to those a
    float32 evaluation took. What separates that evaluation from these is
    its arithmetic alone."""
    x64 = x.double().requires_grad_()
    p64 = [p.double().requires_grad_() for p in params]
    y2 = _edge_bn_outputs(x64, idx, p64, mask1)[1]
    out = torch.where(live, torch.gather(y2, 2, slot[:, :, None]).squeeze(2),
                      0.0)
    return [g.float() for g in torch.autograd.grad(out, [x64, *p64],
                                                   dout.double())]


def _branches(x, idx, params, dout, kernel, twin):
    """The branch each evaluation took (the first layer's relu mask, the
    max's slots, the output's relu mask) for the kernel, ``kernel`` = (out,
    grads, U, V, BN1 table, int32 slots), and for the twin, ``twin`` =
    (out, grads, slots); then each one's gradient errors from float64 on
    its own branch. Returns (flips, tie, sep, errs_kernel, errs_twin):
    ``flips`` the shares of entries that differ, kernel vs twin, kernel vs
    float64 and twin vs float64; ``tie`` how near to a tie (float64 |y1|,
    h2 gap between the two slots, max h2) the farthest disagreement of the
    kernel with float64 lies; ``sep`` the edges where the kernel's mask
    would differ had it rounded its product before the add."""
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et

    out, grads, u, v, bn1, slot = kernel
    r_out, r_grads, r_slot = twin
    with torch.no_grad():
        mask_k, mask_k_sep = _kernel_mask1(u, v, bn1, idx)
        sep = int((mask_k != mask_k_sep).sum())
        del mask_k_sep
        mask_t = _edge_bn_outputs(x, idx, params)[0] > 0
        y1e, y2e = _edge_bn_outputs(x.double(), idx,
                                    [p.double() for p in params])
        mask_e = y1e > 0
        h2e = torch.relu(y2e)
        del y2e
        slot_e, live_e = torch.argmax(h2e, dim=2), h2e.amax(2) > 0
        slot_k, live_k, live_t = slot.long(), out > 0, r_out > 0

        def share(a, b):
            return float((a != b).double().mean())

        flips = {what: [share(*ab) for ab in ((k_, t_), (k_, e_), (t_, e_))]
                 for what, (k_, t_, e_) in (
                     ("h1 mask", (mask_k, mask_t, mask_e)),
                     ("slot", (slot_k, r_slot, slot_e)),
                     ("out > 0", (live_k, live_t, live_e)))}

        def worst(gap, where):
            return float(gap[where].max()) if bool(where.any()) else 0.0

        at = (h2e.gather(2, slot_k[:, :, None])
              - h2e.gather(2, slot_e[:, :, None]))[:, :, 0]
        tie = max(worst(y1e.abs(), mask_k != mask_e),
                  worst(at.abs(), (slot_k != slot_e) & live_k & live_e),
                  worst(h2e.amax(2), live_k != live_e))
        del y1e, h2e, at, mask_e
    torch.cuda.empty_cache()
    errs_k = et.grad_errors(grads, _branch_grads(
        x, idx, params, dout, mask_k, slot_k, live_k))
    errs_t = et.grad_errors(r_grads, _branch_grads(
        x, idx, params, dout, mask_t, r_slot, live_t))
    return flips, tie, sep, errs_k, errs_t


def fused_edge_stage_train_phase(basepath: str):
    """Kernel 5 against its twin at the training shape: the first training
    batch (2 x PAIRS clouds of N points, centred), k=20 over its
    ``knn_points`` graph, C1=64, C2=128; seeded weights and cotangent."""
    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops import knn_kernels as kk

    n, k, c1, c2 = 512, 20, 64, 128
    ds = PackedDataset(basepath)
    train = getDataFiles(f"{basepath}/split/train.txt")[:PAIRS]
    batch = ds.sample_batch(train, n, np.random.default_rng(SEED))
    pts = np.concatenate([batch[0], batch[1]])
    x = torch.from_numpy(pts - pts.mean(axis=1, keepdims=True)).cuda()
    idx = kk.knn_points(x, k)
    rng = np.random.default_rng(SEED + 5)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    def xavier(fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, (fan_in, fan_out))

    params = [t(xavier(6, c1)), t(rng.uniform(-0.2, 0.2, c1)),
              t(rng.uniform(0.5, 2.0, c1)), t(rng.uniform(-0.2, 0.2, c1)),
              t(xavier(c1, c2)), t(rng.uniform(-0.2, 0.2, c2)),
              t(rng.uniform(0.5, 2.0, c2)), t(rng.uniform(-0.2, 0.2, c2))]
    dout = t(rng.normal(size=(x.shape[0], n, c2)))

    def run(fn, keep=None):
        xs = x.clone().requires_grad_()
        ps = [p.clone().requires_grad_() for p in params]
        out, stats = fn(xs, idx, *ps)
        kept = keep(out.grad_fn.saved_tensors) if keep else None
        grads = torch.autograd.grad(out, [xs, *ps], dout)
        return out.detach(), stats, grads, kept

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the kernel's U, V, BN1 table and int32 slot map; the twin's
    # stable_max argmax
    out, stats, grads, (u, v, bn1, slot) = run(
        et.fused_edge_stage_train, lambda s: (s[5], s[6], s[7], s[10]))
    torch.cuda.synchronize()
    mem_kernel = torch.cuda.max_memory_allocated() - base
    grads2 = run(et.fused_edge_stage_train)[2]
    torch.cuda.reset_peak_memory_stats()
    r_out, r_stats, r_grads, r_slot = run(et.fused_edge_stage_train_plain,
                                          lambda s: s[0][:, :, 0])
    torch.cuda.synchronize()
    mem_plain = torch.cuda.max_memory_allocated() - base
    # the twin in float64: how far each float32 result is from the exact one
    x64, p64 = x.double().requires_grad_(), [p.double() for p in params]
    for p in p64:
        p.requires_grad_()
    e_out, _ = et.fused_edge_stage_train_plain(x64, idx, *p64)
    e_grads = [g.float() for g in torch.autograd.grad(e_out, [x64, *p64],
                                                      dout.double())]
    del e_out, x64, p64
    torch.cuda.empty_cache()
    err = float((out - r_out).abs().max())
    ok = torch.allclose(out, r_out, rtol=TRAIN_TOL, atol=TRAIN_ATOL)
    stat_err = max(float((a - b).abs().max()) for a, b in zip(stats, r_stats))
    ok &= all(torch.allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_ATOL)
              for a, b in zip(stats, r_stats))
    errs = et.grad_errors(grads, r_grads)
    errs_k = et.grad_errors(grads, e_grads)
    errs_t = et.grad_errors(r_grads, e_grads)
    repeat = max(float((a - b).abs().max()) for a, b in zip(grads, grads2))
    flips, tie, sep, errs_kb, errs_tb = _branches(
        x, idx, params, dout, (out, grads, u, v, bn1, slot),
        (r_out, r_grads, r_slot))

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: et.fused_edge_stage_train(x, idx, *params))
    ms = cuda_ms(lambda: run(et.fused_edge_stage_train), iters=5)
    plain_ms = cuda_ms(lambda: run(et.fused_edge_stage_train_plain), iters=3)
    print(f"fused_edge_stage_train B={x.shape[0]} N={n} k={k} C1={c1} "
          f"C2={c2}: out max_abs_err={err:.3e}, stats max_abs_err="
          f"{stat_err:.3e} (rtol {TRAIN_TOL}, atol {TRAIN_ATOL})")
    for what, (kt, ke, te) in flips.items():
        print(f"fused_edge_stage_train {what} differing: kernel vs twin "
              f"{kt:.3e}, kernel vs float64 {ke:.3e}, twin vs float64 "
              f"{te:.3e}")
    print(f"fused_edge_stage_train every branch disagreement with float64 "
          f"lies within {tie:.3e} of a tie (limit {TIE_ABS}); the kernel's "
          f"h1 mask rebuilt with a rounded product differs at {sep} edges")
    for label, e in (("kernel vs twin", errs), ("kernel vs float64", errs_k),
                     ("twin vs float64", errs_t),
                     ("kernel vs float64 on the kernel's branch", errs_kb),
                     ("twin vs float64 on the twin's branch", errs_tb)):
        print(f"fused_edge_stage_train gradient rel L2 errors, {label}: "
              + ", ".join(f"{k_}={v:.2e}" for k_, v in e.items()))
    print(f"fused_edge_stage_train two backward runs: max abs difference "
          f"{repeat:.3e}")
    print(f"fused_edge_stage_train kernel forward {fwd_ms:.4f} ms, forward+"
          f"backward {ms:.4f} ms; twin forward+backward {plain_ms:.4f} ms "
          f"(CUDA events); peak device memory above the inputs: kernel "
          f"{mem_kernel / 2**20:.1f} MiB, twin {mem_plain / 2**20:.1f} MiB")
    check(ok, "fused_edge_stage_train disagrees with its twin (forward)")
    check(tie <= TIE_ABS, "fused_edge_stage_train takes a branch that "
          "float64 does not, away from a tie")
    check(max(errs_kb.values()) <= TRAIN_TOL,
          "fused_edge_stage_train gradients disagree with float64 on the "
          "kernel's own branch")
    # The function's least work: one forward product pass (relu(BN2(.)) is
    # monotone in pre2 per channel, so the BN2 sums and the max and min of
    # pre2 come from one pass) and three backward (pre2 again, dW2, dh1,
    # with dh1 kept), each 2 E C1 C2 FLOPs on the FP32 pipes. Bytes: f,
    # idx, weights and dout in, out, df and the weight gradients out
    edges = x.shape[0] * n * k
    flops = 4 * 2.0 * edges * c1 * c2
    nbytes = (4 * (2 * x.numel() + 2 * dout.numel()) + idx.numel() * 8
              + 8 * sum(p.numel() for p in params))
    return (err, ms, plain_ms, *bound(flops, FP32_FLOPS, nbytes))


def _first_step_grads(trainer, batch):
    """The loss and parameter gradients of one training step."""
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    return (float(metrics["losses/loss"]),
            [p.grad.detach().clone() for p in trainer.model.parameters()])


def _step_ms(trainer, batch, steps: int = 3):
    """Host-clock time of one training step, over ``steps`` steps that end
    in a synchronize, after one warm-up step; and the peak memory of a step."""
    trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / steps * 1e3,
            torch.cuda.max_memory_allocated())


def _check_trained(logdir: str, model: str):
    ev = os.path.join(logdir, "val", "eval000000")
    for name in ("eval.json", "eval_180.json", "pred_translations.npy"):
        check(os.path.isfile(os.path.join(ev, name)),
              f"{model} training wrote no {name}")
    for name in ("model.ckpt.pt", "model-0.pt", "config.json"):
        check(os.path.isfile(os.path.join(logdir, name)),
              f"{model} training wrote no {name}")
    with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["losses/loss"] for r in rows]
    check(len(rows) == 3 and all(np.isfinite(losses)),
          f"{model} training: losses {losses}")
    with open(os.path.join(ev, "eval.json")) as f:
        levels = json.load(f)["corr_levels"]
    print(f"{model} training: step losses {[round(v, 5) for v in losses]}, "
          f"eval corr_levels {levels}")


def _capture_edge_stages(model):
    """(snapshot, seen): a copy of each DGCNN backbone of ``model`` as it is
    now, and, filled by the next train-mode forward and backward, the input
    points, graph and momentum of each backbone's fused edge stage and the
    cotangent its output receives."""
    import copy

    from alignnet3d_tpu_torch.models.backbones import DGCNNBackbone

    snapshot, seen = {}, {}
    for name, mod in model.named_modules():
        if not isinstance(mod, DGCNNBackbone):
            continue
        snapshot[name] = copy.deepcopy(mod)

        def fused(x, nn_idx, momentum, _mod=mod, _name=name):
            rec = seen[_name] = {"x": x.detach().clone(), "idx": nn_idx,
                                 "momentum": momentum}
            out = DGCNNBackbone._fused_edge_layers(_mod, x, nn_idx, momentum)
            out.register_hook(lambda g: rec.update(dout=g.detach()))
            return out

        mod._fused_edge_layers = fused
    return snapshot, seen


def _edge_layer_errors(model, snapshot, seen):
    """Relative L2 error of each conv1/bn1/conv2/bn2 gradient that ``model``
    holds after a fused step against the unfused edge layers of the same
    backbones before the step (``snapshot``), run on the points and graph
    the fused stages saw, under the cotangents they received: the heads'
    and the pool over points' choices cannot differ."""
    from alignnet3d_tpu_torch.models.backbones import _pool
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et

    grads = {n: p.grad for n, p in model.named_parameters()}
    absorbed = {"conv1.bias": "bn1.bias", "conv2.bias": "bn2.bias"}
    errs = {}
    for name, rec in seen.items():
        bb = snapshot[name].train()
        leaves = [(n, p) for n, p in bb.named_parameters()
                  if n.split(".")[0] in ("conv1", "bn1", "conv2", "bn2")]
        h = bb._edge_layers(rec["x"], rec["idx"], rec["momentum"],
                            _pool(bb.stable_max_grad))
        ref = torch.autograd.grad(h, [p for _, p in leaves], rec["dout"])
        names = [n for n, _ in leaves]
        got = [grads[f"{name}.{n}"] for n in names]
        errs.update((f"{name}.{n}", e) for n, e in
                    et.grad_errors(got, ref, names, absorbed).items())
    return errs


def dgcnn_training_phase(basepath: str, workdir: str):
    """One epoch of the fused DGCNN through ``Trainer.train()`` with every
    launch count set to 0 before and read after; then the first step of
    the fused and the unfused path from the same weights and batch."""
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops import knn_kernels as kk
    from alignnet3d_tpu_torch.training.trainer import Trainer

    logdir = os.path.join(workdir, "dgcnn_fused")
    cfg = train_config(TRAIN_CONFIG, basepath, logdir, dgcnn_fused_train=True)
    trainer = Trainer(cfg, seed=SEED, device="cuda")
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"DGCNN fused training, 1 epoch (3 steps of {PAIRS} pairs + eval "
          f"of {PAIRS}): {wall:.1f} s; kernel launches {counts}")
    _check_trained(logdir, "DGCNN fused")
    steps = trainer.step
    # 10 launches of kernel 5 per backbone per step, 3 backbones a step;
    # knn_points: 3 a training step and 3 a forward of the eval batch
    check(counts["fused_edge_stage_train"] == 30 * steps,
          f"fused_edge_stage_train: {counts['fused_edge_stage_train']} "
          f"launches, expected {30 * steps}")
    check(counts["knn_points"] == 3 * steps + 3,
          f"knn_points: {counts['knn_points']} launches, expected "
          f"{3 * steps + 3}")

    # fused vs unfused: the same seeded weights, batch and generators; the
    # unfused path again on STEP_SENS_DRAWS perturbed copies of the batch
    train = trainer.train_indices[:PAIRS]
    batch = trainer.dataset.sample_batch(train, trainer.spec.num_points,
                                         np.random.default_rng(SEED + 6))
    rng = np.random.default_rng(SEED + 7)
    runs = [("fused", True, batch), ("unfused", False, batch)]
    for d in range(STEP_SENS_DRAWS):
        runs.append((f"perturbed{d}", False, tuple(
            (a * (1.0 + STEP_SENS_REL * rng.standard_normal(a.shape))).astype(
                np.float32) if i < 2 else a for i, a in enumerate(batch))))
    results = {}
    for name, fused, b in runs:
        cfg = train_config(TRAIN_CONFIG, basepath,
                           os.path.join(workdir, f"step_{name}"),
                           dgcnn_fused_train=fused)
        tr = Trainer(cfg, seed=SEED, device="cuda")
        tr.init_state()
        if fused:
            snapshot, seen = _capture_edge_stages(tr.model)
        loss, grads = _first_step_grads(tr, b)
        if fused:
            check(len(seen) == 3 and all("dout" in r for r in seen.values()),
                  f"fused edge stages seen: {sorted(seen)}")
            edge_errs = _edge_layer_errors(tr.model, snapshot, seen)
            for mod in tr.model.modules():  # the class's own method again
                mod.__dict__.pop("_fused_edge_layers", None)
            del snapshot, seen
        timing = _step_ms(tr, b) if not name.startswith("perturbed") else None
        names = [n for n, _ in tr.model.named_parameters()]
        results[name] = (loss, grads, timing)
        del tr
        torch.cuda.empty_cache()
    (lf, gf, (msf, pkf)), (lu, gu, (msu, pku)) = (results["fused"],
                                                  results["unfused"])
    absorbed = _absorbed_biases(names)
    errs = et.grad_errors(gf, gu, names, absorbed)
    loss_sens, sens = 0.0, dict.fromkeys(names, 0.0)
    for d in range(STEP_SENS_DRAWS):
        lp, gp, _ = results[f"perturbed{d}"]
        s = et.grad_errors(gp, gu, names, absorbed)
        w = max(s, key=s.get)
        print(f"DGCNN first step, unfused vs its input x (1 + "
              f"{STEP_SENS_REL:g} noise), draw {d}: loss rel gap "
              f"{abs(lp - lu) / abs(lu):.2e}; worst gradient rel L2 error "
              f"{s[w]:.2e} ({w})")
        loss_sens = max(loss_sens, abs(lp - lu))
        sens = {n_: max(sens[n_], s[n_]) for n_ in names}
    worst = max(errs, key=errs.get)
    worst_edge = max(edge_errs, key=edge_errs.get)
    print(f"DGCNN first step, fused vs unfused: loss {lf:.7f} vs {lu:.7f} "
          f"(rel gap {abs(lf - lu) / abs(lu):.2e}, rtol {STEP_LOSS_RTOL}); "
          f"worst gradient rel L2 error {errs[worst]:.2e} ({worst}; tol "
          f"{STEP_GRAD_TOL} or {STEP_SENS_FACTOR:g} x its largest gap "
          f"under noise, {STEP_SENS_FACTOR * sens[worst]:.2e})")
    print(f"DGCNN first step, edge layers (conv1/bn1/conv2/bn2) fused vs "
          f"unfused under the fused stages' cotangents: worst gradient rel "
          f"L2 error {edge_errs[worst_edge]:.2e} ({worst_edge}; tol "
          f"{STEP_GRAD_TOL}); "
          + ", ".join(f"{n_}={v:.1e}" for n_, v in edge_errs.items()))
    print(f"DGCNN training step, {PAIRS} pairs (host clock, ends in a "
          f"synchronize): fused {msf:.1f} ms, unfused {msu:.1f} ms; peak "
          f"device memory fused {pkf / 2**30:.2f} GiB, unfused "
          f"{pku / 2**30:.2f} GiB")
    check(max(edge_errs.values()) <= STEP_GRAD_TOL,
          "fused and unfused edge layers' gradients differ")
    check(abs(lf - lu) <= max(STEP_LOSS_RTOL * abs(lu),
                              STEP_SENS_FACTOR * loss_sens),
          "fused and unfused first-step losses differ")
    check(all(errs[n_] <= max(STEP_GRAD_TOL, STEP_SENS_FACTOR * sens[n_])
              for n_ in names),
          "fused and unfused first-step gradients differ")
    return counts


def pointnet_training_phase(basepath: str, workdir: str):
    """One epoch (3 steps + eval) of the PointNet at SynthCars width."""
    from alignnet3d_tpu_torch.training.trainer import Trainer

    logdir = os.path.join(workdir, "pointnet")
    trainer = Trainer(train_config(CONFIG, basepath, logdir), seed=SEED,
                      device="cuda")
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    print(f"PointNet training, 1 epoch (3 steps of {PAIRS} pairs + eval "
          f"of {PAIRS}): {time.perf_counter() - t0:.1f} s")
    _check_trained(logdir, "PointNet")
    train = trainer.train_indices[:PAIRS]
    batch = trainer.dataset.sample_batch(train, trainer.spec.num_points,
                                         np.random.default_rng(SEED + 6))
    step_ms, peak = _step_ms(trainer, batch)
    print(f"PointNet training step, {PAIRS} pairs: {step_ms:.1f} ms; peak "
          f"device memory {peak / 2**30:.2f} GiB")


def _wrappers():
    from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops import knn_kernels as kk
    from alignnet3d_tpu_torch.ops import nn_kernels as nk
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

    return {"fused_pointnet": pk.fused_pointnet, "nn_argmin": nk.nn_argmin,
            "knn_points": kk.knn_points,
            "fused_edge_stage": ek.fused_edge_stage,
            "fused_edge_stage_train": et.fused_edge_stage_train}


def serve(aligner, kinds, requests, sync):
    outs, walls, states = [], [], []
    for (name, kwargs), (pcs1, pcs2) in zip(kinds, requests):
        states.append(aligner._rng.bit_generator.state)
        t0 = time.perf_counter()
        outs.append(aligner.align(pcs1, pcs2, **kwargs))
        sync()
        walls.append(time.perf_counter() - t0)
    return outs, walls, states


def _top2_gap(logits, nb):
    top = np.sort(logits[:, :nb], axis=1)[:, -2:]
    return (top[:, 1] - top[:, 0]) / (1.0 + np.abs(top[:, 1]))


def _answer_gap(t1, c1, a1, t2, c2, a2):
    """Per-pair gap of two answers: the largest of |dt| (m), |dc| (m) and
    the yaw gap (rad)."""
    dt = np.linalg.norm(t1 - t2, axis=1)
    dc = np.linalg.norm(c1 - c2, axis=1)
    return np.maximum(np.maximum(dt, dc), _angle_gap(a1, a2))


def rounding_decided(spec, state, rng_state, pcs1, pcs2, flips: bool):
    """Pairs whose answer hangs on rounding, judged on the CPU run. Returns
    (ties, sensitive): ``ties`` are an argmax of yaw logits within
    TIE_MARGIN, or (with flips) chamfer scores of the two yaw hypotheses
    within TIE_MARGIN of each other; ``sensitive`` are pairs whose answer
    moves by more than NET_ATOL under a SENS_REL input perturbation."""
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu_torch.ops.flip_resolve import resolve_flips

    probe = Aligner(spec, state, batch_size=PAIRS, device="cpu")
    probe._rng.bit_generator.state = rng_state
    a, b = probe._resample(pcs1), probe._resample(pcs2)
    out = {k: v.numpy() for k, v in
           probe._forward(torch.from_numpy(a), torch.from_numpy(b)).items()}
    nb = spec.num_bins
    flagged = np.zeros(len(a), bool)
    for key in ("pred_pc1angle_logits", "pred_pc2angle_logits",
                "pred_remaining_angle_logits"):
        flagged |= _top2_gap(out[key], nb) < TIE_MARGIN
    if flips:
        dec = decode_pair_outputs(out, a, b, nb, probe.residual_scale,
                                  resolve_flips=False, device="cpu")
        _, d, d_flip = resolve_flips(
            torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(dec.translations),
            torch.from_numpy(dec.angles.astype(np.float32)),
            torch.from_numpy(dec.s2_pc1centers))
        d, d_flip = d.numpy(), d_flip.numpy()
        flagged |= np.abs(d - d_flip) <= TIE_MARGIN * np.maximum(d, d_flip)

    def answer(pa, pb, out):
        dec = decode_pair_outputs(out, pa, pb, nb, probe.residual_scale,
                                  resolve_flips=flips, device="cpu")
        return dec.translations, dec.s2_pc1centers, dec.angles

    ref = answer(a, b, out)
    rng = np.random.default_rng(SEED + 4)
    sensitive = np.zeros(len(a), bool)
    for _ in range(SENS_DRAWS):
        pa, pb = ((x * (1.0 + SENS_REL * rng.standard_normal(x.shape)))
                  .astype(np.float32) for x in (a, b))
        out_p = {k: v.numpy() for k, v in probe._forward(
            torch.from_numpy(pa), torch.from_numpy(pb)).items()}
        sensitive |= _answer_gap(*ref, *answer(pa, pb, out_p)) > NET_ATOL
    return flagged, sensitive


def _angle_gap(a, b):
    return np.abs(np.mod(a - b + np.pi, 2 * np.pi) - np.pi)


def cross_check(spec, state, kinds, requests, gpu_outs, states):
    from alignnet3d_tpu_torch.api import Aligner

    cpu = Aligner(spec, state, batch_size=PAIRS, seed=SEED, device="cpu")
    t0 = time.perf_counter()
    cpu_outs, _, _ = serve(cpu, kinds, requests, lambda: None)
    print(f"CPU run of the same requests: {time.perf_counter() - t0:.1f} s")
    for r, ((name, kwargs), g, c) in enumerate(zip(kinds, gpu_outs, cpu_outs)):
        dt = np.linalg.norm(g["translations"] - c["translations"], axis=1)
        dc = np.linalg.norm(g["centers"] - c["centers"], axis=1)
        da = _angle_gap(g["angles"], c["angles"])
        if kwargs.get("refine_icp"):
            agree = (dt <= ICP_TOL[0]) & (np.degrees(da) <= ICP_TOL[1])
            print(f"request {name}: card vs CPU, max gap {dt.max():.3e} m, "
                  f"{np.degrees(da).max():.3e} deg; within {ICP_TOL[0]} m and "
                  f"{ICP_TOL[1]} deg: {agree.mean():.1%} of pairs")
            check(agree.mean() >= ICP_AGREE,
                  f"request {name}: card and CPU ICP answers disagree")
            continue
        pcs1, pcs2 = requests[r]
        ties, sensitive = rounding_decided(spec, state, states[r], pcs1, pcs2,
                                           kwargs.get("resolve_flips", False))
        aside = ties | sensitive
        gap = np.maximum(np.maximum(dt, dc), da)
        ok = gap <= NET_ATOL
        print(f"request {name}: card vs CPU, max gap {gap[~aside].max():.3e} "
              f"over {int((~aside).sum())} pairs (atol {NET_ATOL}); "
              f"{int(ties.sum())} pairs at a near-tie, {int(sensitive.sum())} "
              f"moved > {NET_ATOL} by a {SENS_REL:g} input perturbation; of "
              f"those {int((~ok & aside).sum())} differ (max gap "
              f"{gap.max():.3e})")
        check(ok[~aside].all(), f"request {name}: card and CPU answers differ")
        check(ties.mean() <= 0.05, f"request {name}: too many near-ties")
        check(sensitive.mean() <= SENS_SHARE,
              f"request {name}: too many rounding-sensitive pairs")


def serve_path(spec, state, kinds, requests, owned):
    """Warm the path up on a throwaway server, time the folded forward
    alone, then serve ``requests`` with every launch count set to 0 just
    before and read just after; every kernel in ``owned`` must have
    launched. Cross-check the answers on the CPU. Returns the counts."""
    from alignnet3d_tpu_torch.api import Aligner

    wrappers = _wrappers()
    # warm-up of every path (cuBLAS handles, allocator), so that the
    # request times below are steady-state times
    warm = Aligner(spec, state, batch_size=PAIRS, seed=SEED + 1, device="cuda")
    warm.align(*requests[-1], **kinds[-1][1])
    a = torch.from_numpy(warm._resample(requests[0][0])).cuda()
    b = torch.from_numpy(warm._resample(requests[0][1])).cuda()
    fwd_ms = cuda_ms(lambda: warm._forward(a, b))
    print(f"{spec.backbone} folded forward, {PAIRS} pairs, "
          f"{spec.compute_dtype}: {fwd_ms:.4f} ms (CUDA events)")

    aligner = Aligner(spec, state, batch_size=PAIRS, seed=SEED, device="cuda")
    for fn in wrappers.values():
        fn.launches = 0
    gpu_outs, walls, states = serve(aligner, kinds, requests,
                                    torch.cuda.synchronize)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for (name, _), wall, out in zip(kinds, walls, gpu_outs):
        check(all(np.isfinite(v).all() for v in out.values()),
              f"request {name}: non-finite answer")
        check(out["transforms"].shape == (PAIRS, 4, 4),
              f"request {name}: wrong shape")
        print(f"request {name}: {PAIRS} pairs in {wall * 1e3:.1f} ms "
              f"(host clock, ends in a synchronize)")
    print(f"kernel launches while serving the {spec.backbone} requests: "
          f"{counts}")
    for name in owned:
        check(counts[name] > 0,
              f"{name} never launched on the {spec.backbone} path")
    cross_check(spec, state, kinds, requests, gpu_outs, states)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        print(f"chip_smoke: needs sm_90, found sm_{major}{minor}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")

    t0 = time.perf_counter()
    requests = make_requests()
    sizes = [len(p) for pcs in requests for half in pcs for p in half]
    print(f"{len(REQUESTS)} requests x {PAIRS} pairs generated in "
          f"{time.perf_counter() - t0:.1f} s; points per cloud "
          f"min {min(sizes)} median {int(np.median(sizes))} max {max(sizes)}")

    specs = {}
    for name, path in (("pointnet", CONFIG), ("dgcnn", DGCNN_CONFIG)):
        with open(path) as f:
            spec = ModelSpec.from_config(config_from_dict(json.load(f)))
        specs[name] = (spec, seeded_weights(spec))
        print(f"model: {path.name}, {spec.backbone}, N={spec.num_points}, "
              f"bins={spec.num_bins}, s1 {spec.s1_backbone}, "
              f"s2 {spec.s2_backbone}, embedding {spec.embedding}, "
              f"heads {spec.s1_mlp}, {spec.compute_dtype}")

    spec, state = specs["pointnet"]
    k1 = fused_pointnet_phase(spec, state, requests[0][0] + requests[0][1])
    k2 = nn_argmin_phase(spec, *requests[2])
    dspec, dstate = specs["dgcnn"]
    graph, k3 = knn_points_phase(dspec, requests[0][0] + requests[0][1])
    k4 = fused_edge_stage_phase(dspec, dstate, graph)

    paths = (  # (model, request kinds, requests, kernels that must launch)
        ("pointnet", REQUESTS, requests, ("fused_pointnet", "nn_argmin")),
        ("dgcnn", DGCNN_REQUESTS, requests[:len(DGCNN_REQUESTS)],
         ("knn_points", "fused_edge_stage")),
    )
    launches = {}
    for model, kinds, reqs, owned in paths:
        counts = serve_path(*specs[model], kinds, reqs, owned)
        launches.update((name, counts[name]) for name in owned)
        if model == "dgcnn":
            # one forward batch per request, 3 backbones per forward
            for name in owned:
                check(counts[name] == 3 * len(kinds),
                      f"{name}: {counts[name]} launches, expected "
                      f"{3 * len(kinds)}")

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        basepath = os.path.join(workdir, "data")
        t0 = time.perf_counter()
        splits = make_dataset(basepath)
        print(f"dataset: {len(splits['train'])} train + {len(splits['val'])} "
              f"val pairs generated in {time.perf_counter() - t0:.1f} s")
        k5 = fused_edge_stage_train_phase(basepath)
        counts = dgcnn_training_phase(basepath, workdir)
        launches["fused_edge_stage_train"] = counts["fused_edge_stage_train"]
        pointnet_training_phase(basepath, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    emb = k1[("embedding", torch.float32)]
    edge = k4["embedding"]
    rows = (  # name, source, TPU kernel, (err, ms, plain, bound, bound_by)
        ("fused_pointnet", "fused_pointnet.cu",
         "alignnet3d_tpu/ops/pointnet_kernels.py:74", emb),
        ("nn_argmin", "nn_argmin.cu",
         "alignnet3d_tpu/ops/nn_kernels.py:80", k2["icp"]),
        ("knn_points", "knn_points.cu",
         "alignnet3d_tpu/ops/knn_kernels.py:68", k3["requests"]),
        ("fused_edge_stage", "edge_stage.cu",
         "alignnet3d_tpu/ops/edge_conv_kernels.py:78", edge),
        ("fused_edge_stage_train", "edge_train.cu",
         "alignnet3d_tpu/ops/edge_train_kernels.py:421", k5),
    )
    # library_ms is null: no one PyTorch call computes any of these
    # functions (a fused chain + max, a masked argmin, an ordered top-k
    # with index ties, a gathered 2-layer chain + max, the same with
    # batch-statistic BN and its gradient)
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"alignnet3d_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": r[0], "ms": r[1],
         "plain_ms": r[2], "bound_ms": r[3], "bound_by": r[4],
         "library_ms": None}
        for name, src, replaces, r in rows
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
