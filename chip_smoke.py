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
   pairs); builds the native batch assembler (``csrc/loader.cpp``, g++)
   and holds ``sample_batch``'s default path bit-equal to its numpy twin,
   timing a batch of 128 pairs at N=512 and 1024 native against numpy;
   feeds a NaN (and an infinite) point to kernels 1-5 and holds
   their answers to the twins', and checks that a fused DGCNN
   training step on a batch with a NaN point gives a non-finite loss (the
   ``Trainer``'s guard); holds the fused training edge stage against its
   twin at the training shape, forward and backward, and its gradients
   against float64 on the branch (relu masks, max slots) it took;
8. trains one epoch (3 steps + the dual eval) of the DGCNN of
   ``configs/SynthCars40kDGCNNFusedR4.json`` with ``dgcnn_fused_train`` on,
   through ``Trainer.train()``, counting launches, and compares its first
   step with the unfused path's from the same weights and batch, the edge
   layers also under the same cotangent; then trains it data-parallel
   (``parallel/multihost.py``): one process on NCCL through the CLI with the
   ``ALIGNNET_*`` variables against that epoch; two processes on the one
   card over gloo, 64 rows each: their first step against one process's on
   the same 128 pairs, an epoch and ``eval_only`` through the CLI (equal
   parameters, each process's launches of kernels 3 and 5, the eval
   against one process's); serves the PointNet folded forward in int8
   (``quantize`` 'embedding' and 'backbones') on the card against the CPU,
   timed beside float32 and bf16; and holds one training step of the bf16
   PointNet and fused DGCNN and of the ``stack_siamese=False`` PointNet on
   the card against the CPU;
9. trains one epoch of the PointNet of ``configs/SynthCars.json``, with a
   ``tpu.profile`` trace of its steps 1-2 and the card's busy share there;
   then the completion head: one epoch of ``configs/SynthCars40kComp.json``
   (N=1024, 256 completion points) with a trace, its first step held
   against the CPU, and its run served with flips; then the KITTI
   toolchain: a synthetic KITTI tracking tree through ``kitti_generate``,
   one epoch of ``configs/KITTITrackletsCars.json`` through the CLI
   pretrained from the PointNet run, its run served with flips, and
   ``evaluation.special.mode 'held'`` with it on the card and the CPU;
10. the eval-time stack through ``alignnet3d_tpu_torch.cli``: trains one
    epoch of ``configs/SynthCars80kFullStack.json`` (voxel view, network
    refine in the eval), runs ``eval_only --refineICP`` with it (gated
    p2plane ICP) and with ``configs/SynthCars80kNetRefineCascade.json``
    (a gated 2-stage p2p cascade), counting launches, and holds ICP from
    perturbed ground truth on the card against the CPU;
11. trained runs across the two packages: writes that FullStack run as
    the JAX package's flax ``model-0.msgpack`` (``checkpoint.py``) and
    reads it back bit-equal, serves both files through
    ``Aligner.from_checkpoint`` with bit-equal answers, trains one epoch
    of ``configs/SynthCars80kRefiner.json`` (the residual task) through
    the CLI with the ``.msgpack`` run as its pretrained model, and serves
    the two-stage request (flips, network refine with the refiner, ICP),
    counting launches, held against the CPU on the same inputs;
12. the classical baselines (``evaluation.special.mode 'icp'``): the five
    variants of ``make_icp_configs.py`` (p2point, FPFH + RANSAC, FPFH +
    FGR, both refined by p2p ICP) and multistart through
    ``alignnet3d_tpu_torch.cli`` over the 128 val pairs, in
    ``eval_icp.sh``'s order, counting launches; the same runner on 16 of
    the pairs (multistart on 4) on the card and on the CPU, compared pair
    by pair; recovery
    of a 137 degree motion on the 32 largest clouds, card against CPU; and
    kernel 2 at multistart's coarse shape (1,024 x 4,096 points);
13. exports the folded forward of both models (``alignnet3d_tpu_torch.
    export``, ``torch.export`` with the kernels as ``torch.library`` custom
    ops) on the card and on the CPU, and holds every artifact bit-equal to
    the eager forward on the card at 1, 8 and 128 pairs, counting its
    kernel launches; runs the card's artifacts on the CPU against the card;
    times the exported and eager forwards and the requests again (between
    steps 6 and 7);
14. generates a SynthCarsMesh dataset through ``python -m
    alignnet3d_tpu_torch.data.generate`` at the default sensor with the
    port's g++ raycaster (``csrc/raycast.cpp``), holds two scenes' scans
    against the numpy sweep and the SynthCars CLI against a direct
    ``generate_dataset`` call, and serves a flips request of the mesh
    dataset's val pairs (after step 13);
15. prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

Any failed phase exits non-zero without the last line. So does a machine
without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
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
FULLSTACK_CONFIG = ROOT / "configs" / "SynthCars80kFullStack.json"
CASCADE_CONFIG = ROOT / "configs" / "SynthCars80kNetRefineCascade.json"
REFINER_CONFIG = ROOT / "configs" / "SynthCars80kRefiner.json"
COMP_CONFIG = ROOT / "configs" / "SynthCars40kComp.json"
KITTI_CONFIG = ROOT / "configs" / "KITTITrackletsCars.json"
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
# cores, dense TF32 on the tensor cores, and device memory
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
FP32_LANE_OPS = FP32_FLOPS / 2   # an FMA counts as two FLOPs
HBM_BYTES = 3.35e12
EDGE_TOL = 1e-5          # edge stage vs twin: 3xTF32 products (f32
#                          accuracy) summed over C1 in another order
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
ICP_ITS = 30             # Aligner.align's default ICP iterations
ICP_TOL = (0.01, 0.1)    # m, degrees
ICP_AGREE = 0.95         # share of ICP pairs within ICP_TOL
REFINE_PERTURB = (3.0, 0.10)  # deg, m: the ICP check's inits off the truth
REFINE_CPU_PAIRS = 32    # of the PAIRS val pairs, also refined on the CPU
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
# its input points (~2 f32 ulps). The edge layers that kernel 5 replaces,
# with the cotangent fixed, are held to float64 on the kernel's own branch
# within STEP_GRAD_TOL, and to the unfused layers by the same rule as the
# whole step: the unfused float32 layers settle near-ties their own way,
# which moved a gradient by up to 1.7e-3 between batches (PR 11).
STEP_SENS_REL = 1e-7
STEP_SENS_DRAWS = 3
STEP_SENS_FACTOR = 2.0
DP_RANKS = 2             # processes of the data-parallel run, one card
DP_STEP_ITERS = 3        # timed steps of each side of the DP step check
DP_LOSS_RTOL = 1e-5      # DP first step vs 1 process: the loss and the
DP_RTOL, DP_ATOL = 2e-4, 2e-5  # BN statistics
# (tests/test_sharding_equivalence.py); each parameter's update (its value
# less its initial one) is held by relative L2 to the step's noise rule
# (STEP_GRAD_TOL or STEP_SENS_FACTOR x its gap under STEP_SENS_REL input
# noise): rounding moves near-tied maxima. The same rule must reject each
# of DP_FAULTS, planted in kernel 5's backward of the DP processes
DP_FAULTS = ("dg_dbeta_reduced_twice", "sa1_sb1_not_reduced")
# 1 process on NCCL vs no process group: the first two steps' losses, rel
# gap by step. The first step is bit-equal; the next is not even between
# two non-distributed runs of one tree: kernel 5 scatters dV with atomics,
# and the rounding moves near-tied maxima and the theta / theta + pi picks
# (two such runs on an H100 differed by up to 3.3e-5 at step 2)
DP_SAME_RTOL = (0.0, 1e-3)
OPTION_PAIRS = 16        # card vs CPU steps of bf16 and stack_siamese=False
OPTION_TOL = {False: STEP_GRAD_TOL, True: 2e-2}   # by bf16
OPTION_SENS = {False: STEP_SENS_REL, True: 1e-3}  # < 1 bf16 step for bf16
OPTION_DRAWS = 8         # noise draws of each option step on the card
OPTION_FLOOR = 1e-2      # a gradient's error is relative to its norm, or
# this share of the whole gradient's when smaller: the bf16 DGCNN's
# gradients are chaotic at the rounding level, and a near-zero one (a head's
# last bias) is all noise (on an H100: 1.49 of itself, card vs CPU)
INT8_REL = 1e-3          # int8 forward, card vs CPU, rel L2 an output
SPIN_CYCLES = 400_000    # device_ms: ~0.2 ms of spinning per timed call
# the classical baselines: make_icp_configs.py's variants and multistart, in
# eval_icp.sh's order (each base before its *_p2p)
BASELINE_ORDER = ("o3_p2p", "o3_gicp", "o3_gicp_fast", "o3_gicp_p2p",
                  "o3_gicp_fast_p2p", "multistart")
# nn_argmin launches per run of PAIRS pairs (one chunk): ICP_ITS + 1 (the
# final score); multistart adds a coarse pass of 15 iterations + 1
BASELINE_LAUNCHES = {"o3_p2p": ICP_ITS + 1, "o3_gicp": 0, "o3_gicp_fast": 0,
                     "o3_gicp_p2p": ICP_ITS + 1,
                     "o3_gicp_fast_p2p": ICP_ITS + 1,
                     "multistart": 16 + ICP_ITS + 1}
BASELINE_CPU_PAIRS = 16  # of the PAIRS val pairs, also run on the CPU
MULTISTART_CPU_PAIRS = 4  # multistart's: 8 yaw hypotheses a pair
# share of pairs within ICP_TOL, card vs CPU: the ICP-based variants, and
# the global registrations alone (their features and matches can settle a
# near-tie by rounding)
BASELINE_AGREE = {"o3_p2p": ICP_AGREE, "o3_gicp_p2p": ICP_AGREE,
                  "o3_gicp_fast_p2p": ICP_AGREE, "multistart": ICP_AGREE,
                  "o3_gicp": 0.90, "o3_gicp_fast": 0.90}
RECOVERY_CLOUDS = 32     # the largest val clouds, each against itself moved
RECOVERY_MOTION = ((0.5, -0.3, 0.0), 2.4)   # m, rad (~137 deg)
RECOVERY_TOL = 0.02      # m, median point error of a recovered cloud
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
PROFILE_STEPS = 2        # tpu.profile: a trace of steps 1-2 of epoch 0
LOADER_POINTS = (512, 1024)  # sample_batch of PAIRS pairs at these N
LOADER_REPEATS = 10      # batches timed per path and N (median)
# The synthetic KITTI tracking tree: sequences 0 and 1 go to the training
# split, 2 (one of kitti_generate's val sequences) to the val split; each
# has KITTI_CARS car tracks and one pedestrian track (which the Cars recipe
# filters out) over KITTI_FRAMES frames of KITTI_CLUTTER background points,
# so 2 x 4 x 32 = 256 training pairs (2 steps of PAIRS) and 128 val pairs.
KITTI_SEQS = (0, 1, 2)
KITTI_CARS = 4
KITTI_FRAMES = 33
KITTI_CLUTTER = 20_000
KITTI_DT = 0.1           # s between frames (KITTI's 10 Hz), held timestamps
GEN_TRAIN, GEN_VAL = 64, 32      # SynthCarsMesh scenes through the CLI
GEN_BOX_TRAIN, GEN_BOX_VAL = 8, 4  # SynthCars scenes, CLI vs a direct call
# The native raycaster runs Moller-Trumbore in float32, its numpy sweep in
# float64: a hit point moves by float32 roundings of t (RAY_ATOL, 1/50 of
# the scans' 5 cm noise), and a ray that grazes a triangle edge can hit on
# one side and miss on the other. At most RAY_COUNT_TOL such rays a scan.
RAY_ATOL = 1e-3          # m
RAY_COUNT_TOL = 4


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


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Time on the card alone: the calls are enqueued while the card spins
    (``torch.cuda._sleep``, longer than the enqueueing), so they run back
    to back and the events see no host time between them. ``cuda_ms`` also
    counts the host's time where it is the slower side."""
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


def warm_card(seconds: float = 1.0):
    """Keep the card busy for a while, so that the first phase is not timed
    while its clocks rise from idle."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a @ a
        torch.cuda.synchronize()


def bound(ops: float, op_rate: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card needs for ``ops``
    operations at ``op_rate`` and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = ops / op_rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pointnet_inputs(spec, state, clouds):
    """Kernel 1's inputs at the stacked serving batch (2 x PAIRS clouds of
    N points, centred) and the three folded chains {name: (widths, weights,
    biases)}, on the card."""
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
    return x, {name: (widths, *_fold_chain(state, prefix, len(widths), "cuda"))
               for name, (prefix, widths) in chains.items()}


def fused_pointnet_phase(spec, state, clouds):
    """Kernel 1 against its twin on the three folded chains, f32 and bf16,
    at the stacked serving batch (2 x PAIRS clouds of N points)."""
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

    x, chains = pointnet_inputs(spec, state, clouds)
    n = x.shape[1]
    result = {}
    for name, (widths, ws, bs) in chains.items():
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            got = pk.fused_pointnet(x, ws, bs, dtype)
            ref = pk.fused_pointnet_plain(x, ws, bs, dtype)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, rtol=tol, atol=tol)
            ms = cuda_ms(lambda: pk.fused_pointnet(x, ws, bs, dtype), iters=30)
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


def nn_inputs(spec, pcs1, pcs2):
    """Kernel 2's inputs {name: (src, dst, dst mask, src mask)}, numpy: the
    flip shape (PAIRS x N, full masks) and the ICP shape (PAIRS x up to
    4096 points, prefix masks), as the serving path pads them."""
    rng = np.random.default_rng(SEED + 2)
    n = spec.num_points
    flip = [np.stack([c[rng.integers(0, len(c), n)] for c in pcs])
            for pcs in (pcs1, pcs2)]
    a1, m1 = _ragged(pcs1, 4096, rng)
    a2, m2 = _ragged(pcs2, 4096, rng)
    full = np.ones(flip[1].shape[:2], bool)
    return {"flip": (flip[0], flip[1], full, full), "icp": (a1, a2, m2, m1)}


def nn_argmin_phase(spec, pcs1, pcs2):
    """Kernel 2 against its twin at the flip shape and the ICP shape: the
    indices and distances must be bit-equal."""
    from alignnet3d_tpu_torch.ops import nn_kernels as nk

    result = {}
    for name, (src, dst, mask, src_mask) in nn_inputs(spec, pcs1, pcs2).items():
        src, dst, mask = (torch.from_numpy(v).cuda() for v in (src, dst, mask))
        idx, d2 = nk.nn_argmin(src, dst, mask)
        ri, rd = nk.nn_argmin_plain(src, dst, mask)
        torch.cuda.synchronize()
        equal = bool(torch.equal(idx, ri) and torch.equal(d2, rd))
        err = float((d2 - rd).abs().max())
        ms = cuda_ms(lambda: nk.nn_argmin(src, dst, mask), iters=30)
        dev_ms = device_ms(lambda: nk.nn_argmin(src, dst, mask), iters=30)
        plain_ms = cuda_ms(lambda: nk.nn_argmin_plain(src, dst, mask), iters=3)
        print(f"nn_argmin {name} B={src.shape[0]} n1={src.shape[1]} "
              f"n2={dst.shape[1]} valid={int(mask.sum())}: "
              f"idx differ {int((idx != ri).sum())}, bit-equal={equal}, "
              f"d2 max_abs_err={err:.3e}; kernel {ms:.4f} ms (on the card "
              f"alone {dev_ms:.4f} ms), plain {plain_ms:.4f} ms")
        check(equal, f"nn_argmin {name} is not bit-equal to its twin")
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
        # the kernel's route: the k x C1 x C2 product per point in three
        # TF32 passes on the tensor cores (3xTF32), plus the U/V products
        # (2 x 2 x 3 x C1 per point) on the FP32 pipes, counted here at
        # their FP32 time; beside it the FP32-pipe bound of the function.
        # bytes: U, V, idx, out
        prod = 2.0 * b * n * k * c1 * c2
        uv = 2.0 * b * n * 2 * x.shape[-1] * c1
        nbytes = 4 * b * n * (2 * c1 + c2) + idx.numel() * 8
        tc = bound(3 * prod + uv * TF32_FLOPS / FP32_FLOPS, TF32_FLOPS,
                   nbytes)
        fp32 = bound(prod + uv, FP32_FLOPS, nbytes)
        print(f"fused_edge_stage {name} bound: {tc[0]:.4f} ms by {tc[1]} "
              f"(3xTF32 on the tensor cores, the kernel's route); "
              f"{fp32[0]:.4f} ms by {fp32[1]} on the FP32 pipes")
        result[name] = (err, ms, plain_ms, *tc)
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


def train_config(path: Path, basepath: str, logdir: str,
                 tpu: dict | None = None, **options):
    """The config at ``path`` for one epoch on the generated dataset, with
    ``model.options`` overridden by ``options`` and ``tpu`` by ``tpu``."""
    from alignnet3d_tpu_torch.config import config_from_dict

    with open(path) as f:
        d = json.load(f)
    d["data"]["basepath"] = basepath
    d["logging"] = {"basedir": logdir, "logdir": logdir}
    d["model"]["options"].update(options)
    d["training"]["num_epochs"] = 1
    if tpu:
        d.setdefault("tpu", {}).update(tpu)
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
    # The function's least work: three product passes of 2 E C1 C2 FLOPs on
    # the FP32 pipes, pre2 forward and dh1 = dpre2 W2^T, dW2 = h1^T dpre2
    # backward. The kernel runs a fourth, pre2 rebuilt in bwd_mid, so that
    # no (B N k, C2) tensor is stored: a design choice, not the function's
    # work (storing pre2 would move ~2.7 GB, ~0.8 ms, under the 3 passes).
    # Bytes: f, idx, weights and dout in, out, df and the weight gradients
    # out
    edges = x.shape[0] * n * k
    flops = 3 * 2.0 * edges * c1 * c2
    nbytes = (4 * (2 * x.numel() + 2 * dout.numel()) + idx.numel() * 8
              + 8 * sum(p.numel() for p in params))
    bound_ms, bound_by = bound(flops, FP32_FLOPS, nbytes)
    print(f"fused_edge_stage_train kernel forward {fwd_ms:.4f} ms, forward+"
          f"backward {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}); twin "
          f"forward+backward {plain_ms:.4f} ms (CUDA events); peak device "
          f"memory of a forward+backward call above its inputs: kernel "
          f"{mem_kernel / 2**20:.1f} MiB, twin {mem_plain / 2**20:.1f} MiB")
    check(ok, "fused_edge_stage_train disagrees with its twin (forward)")
    check(tie <= TIE_ABS, "fused_edge_stage_train takes a branch that "
          "float64 does not, away from a tie")
    check(max(errs_kb.values()) <= TRAIN_TOL,
          "fused_edge_stage_train gradients disagree with float64 on the "
          "kernel's own branch")
    return (err, ms, plain_ms, bound_ms, bound_by)


def _same_nan(got, ref, tol):
    """NaN in the same places, the rest (infinities included) within tol."""
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.allclose(got[~nan], ref[~nan], rtol=tol, atol=tol))


def nan_phase(spec, state, clouds, pcs1, pcs2, basepath: str, workdir: str):
    """Kernels 1-5 against their twins on inputs with a NaN and an infinite
    point: kernel 1 on the embedding chain at the serving batch, kernel 2
    at the flip shape (bit-equal), kernels 3-5 on 16 clouds of 512 points
    (kernel 3 bit-equal; kernel 4 over the finite points' graph and over
    kernel 3's graph of the non-finite cloud, with NaN and +-inf); then one
    fused DGCNN training step on a batch with a NaN point, whose loss must
    be non-finite, as the Trainer's guard reads it."""
    from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.ops import knn_kernels as kk
    from alignnet3d_tpu_torch.ops import nn_kernels as nk
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk
    from alignnet3d_tpu_torch.training.trainer import Trainer

    x, chains = pointnet_inputs(spec, state, clouds)
    _, ws, bs = chains["embedding"]
    x[3, 7, 1] = float("nan")
    x[5, 11, 0] = float("inf")
    got = pk.fused_pointnet(x, ws, bs)
    ref = pk.fused_pointnet_plain(x, ws, bs)
    torch.cuda.synchronize()
    ok1 = _same_nan(got, ref, 1e-4)
    print(f"NaN phase, fused_pointnet embedding B={x.shape[0]}: NaN outputs "
          f"kernel {int(got.isnan().sum())}, twin {int(ref.isnan().sum())}; "
          f"the rest within 1e-4: {ok1}")
    check(ok1 and bool(ref.isnan().any()),
          "fused_pointnet: a NaN point's answer disagrees with the twin's")

    src, dst, mask, _ = nn_inputs(spec, pcs1, pcs2)["flip"]
    src, dst, mask = (torch.from_numpy(v.copy()).cuda()
                      for v in (src, dst, mask))
    src[2, 9, 0] = float("nan")
    dst[4, 100, 2] = float("nan")
    dst[6, 0, 1] = float("inf")
    idx, d2 = nk.nn_argmin(src, dst, mask)
    ri, rd = nk.nn_argmin_plain(src, dst, mask)
    torch.cuda.synchronize()
    ok2 = bool(torch.equal(idx, ri)) and _same_nan(d2, rd, 0.0)
    print(f"NaN phase, nn_argmin flip shape: NaN distances kernel "
          f"{int(d2.isnan().sum())}, twin {int(rd.isnan().sum())}; "
          f"bit-equal: {ok2}")
    check(ok2, "nn_argmin: non-finite points' answers differ from the twin's")

    rng = np.random.default_rng(SEED + 8)
    f = torch.from_numpy(rng.normal(size=(16, 512, 3)).astype(np.float32))
    f = f.cuda()
    idx = kk.knn_points(f, 20)
    params = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.normal(size=(6, 64)) * 0.4, rng.normal(size=64) * 0.1,
        1 + 0.2 * rng.normal(size=64), 0.1 * rng.normal(size=64),
        rng.normal(size=(64, 128)) / 8.0, rng.normal(size=128) * 0.1,
        1 + 0.2 * rng.normal(size=128), 0.1 * rng.normal(size=128))]
    edge_weights = [params[i] for i in (0, 1, 4, 5)]  # w1, b1, w2, b2
    for value in (float("nan"), float("inf"), float("-inf")):
        g = f.clone()
        g[1, 9, 2] = value
        got = kk.knn_points(g, 20)
        ref = kk.knn_points_plain(g, 20)
        torch.cuda.synchronize()
        ok3 = bool(torch.equal(got, ref))
        print(f"NaN phase, knn_points with a point at {value}: rows that "
              f"differ from the twin {int((got != ref).any(-1).sum())}; "
              f"bit-equal: {ok3}")
        check(ok3, "knn_points: a non-finite point's graph differs from the "
              "twin's")
        for name, graph in (("finite graph", idx), ("kernel 3 graph", got)):
            out = ek.fused_edge_stage(g, graph, *edge_weights)
            r_out = ek.fused_edge_stage_plain(g, graph, *edge_weights)
            torch.cuda.synchronize()
            ok4 = _same_nan(out, r_out, EDGE_TOL)
            print(f"NaN phase, fused_edge_stage with a point at {value}, "
                  f"{name}: NaN kernel {int(out.isnan().sum())} twin "
                  f"{int(r_out.isnan().sum())}, inf kernel "
                  f"{int(out.isinf().sum())} twin {int(r_out.isinf().sum())};"
                  f" NaN in the same places, the rest within {EDGE_TOL}: "
                  f"{ok4}")
            check(ok4 and not bool(torch.isfinite(r_out).all()),
                  "fused_edge_stage: a non-finite point's answer differs "
                  "from the twin's")

    for value in (float("nan"), float("inf")):
        f[1, 9, 2] = value
        with torch.no_grad():
            out, stats = et.fused_edge_stage_train(f, idx, *params)
            r_out, r_stats = et.fused_edge_stage_train_plain(f, idx, *params)
        torch.cuda.synchronize()
        ok5 = all(_same_nan(a, b, TRAIN_TOL)
                  for a, b in zip((out, *stats), (r_out, *r_stats)))
        share = [float(o.isnan().double().mean()) for o in (out, r_out)]
        print(f"NaN phase, fused_edge_stage_train with f = {value} at one "
              f"point: NaN share of out kernel {share[0]:.3f}, "
              f"twin {share[1]:.3f}; of the "
              f"statistics kernel {sum(int(s.isnan().sum()) for s in stats)}, "
              f"twin {sum(int(s.isnan().sum()) for s in r_stats)}; NaN in "
              f"the same places: {ok5}")
        check(ok5 and bool(r_out.isnan().any()),
              "fused_edge_stage_train: a non-finite point's answer differs "
              "from the twin's")

    cfg = train_config(TRAIN_CONFIG, basepath, os.path.join(workdir, "nan"),
                       dgcnn_fused_train=True)
    trainer = Trainer(cfg, seed=SEED, device="cuda")
    trainer.init_state()
    batch = trainer.dataset.sample_batch(trainer.train_indices[:PAIRS],
                                         trainer.spec.num_points,
                                         np.random.default_rng(SEED + 9))
    pc1 = batch[0].copy()
    pc1[3, 7, 1] = np.nan
    loss = float(trainer.train_step((pc1, *batch[1:]))["losses/loss"])
    print(f"NaN phase, fused DGCNN training step with a NaN point: loss "
          f"{loss}")
    check(not np.isfinite(loss), "a fused DGCNN step on a NaN point gave a "
          "finite loss: the Trainer's guard would not fire")
    del trainer
    torch.cuda.empty_cache()


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
    points, graph and momentum of each backbone's fused edge stage, the
    kernel's saved U, V, BN1 table, output and slots, and the cotangent its
    output receives."""
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
            saved = out.grad_fn.saved_tensors
            rec["kernel"] = (saved[5], saved[6], saved[7], saved[9],
                             saved[10])
            out.register_hook(lambda g: rec.update(dout=g.detach()))
            return out

        mod._fused_edge_layers = fused
    return snapshot, seen


# the edge layers' parameters by their names in the kernel's signature
# (edge_train_kernels.GRAD_NAMES after f), in its order
_KERNEL_LAYOUT = {"conv1.weight": "w1", "conv1.bias": "b1", "bn1.scale": "g1",
                  "bn1.bias": "be1", "conv2.weight": "w2", "conv2.bias": "b2",
                  "bn2.scale": "g2", "bn2.bias": "be2"}


def _edge_layer_errors(model, snapshot, seen):
    """Relative L2 errors of each conv1/bn1/conv2/bn2 gradient that
    ``model`` holds after a fused step, each backbone's edge layers run
    again as they were before the step (``snapshot``) on the points and
    graph its fused stage saw, under the cotangent it received (so the
    heads' and the pool over points' choices cannot differ). Returns
    (against the unfused float32 layers; the unfused layers' own largest
    gap when their input points move by STEP_SENS_REL, over
    STEP_SENS_DRAWS draws; against float64 on the kernel's own branch: its
    relu masks and max slots). The unfused layers take their own branch at
    each near-tie, so their gap to the kernel can be as large as their
    spread under noise; float64 on the kernel's branch leaves the kernel's
    arithmetic alone."""
    from alignnet3d_tpu_torch.models.backbones import _pool
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et

    grads = {n: p.grad for n, p in model.named_parameters()}
    absorbed = {"conv1.bias": "bn1.bias", "conv2.bias": "bn2.bias"}
    rng = np.random.default_rng(SEED + 10)
    errs, sens, branch = {}, {}, {}
    for name, rec in seen.items():
        bb = snapshot[name].train()
        leaves = [(n, p) for n, p in bb.named_parameters()
                  if n in _KERNEL_LAYOUT]
        names = [n for n, _ in leaves]

        def unfused(x):
            h = bb._edge_layers(x, rec["idx"], rec["momentum"],
                                _pool(bb.stable_max_grad))
            return torch.autograd.grad(h, [p for _, p in leaves],
                                       rec["dout"])

        ref = unfused(rec["x"])
        got = [grads[f"{name}.{n}"] for n in names]
        errs.update((f"{name}.{n}", e) for n, e in
                    et.grad_errors(got, ref, names, absorbed).items())
        for _ in range(STEP_SENS_DRAWS):
            noise = torch.from_numpy(rng.standard_normal(
                tuple(rec["x"].shape)).astype(np.float32)).cuda()
            moved = unfused(rec["x"] * (1.0 + STEP_SENS_REL * noise))
            for n, e in et.grad_errors(moved, ref, names, absorbed).items():
                sens[f"{name}.{n}"] = max(sens.get(f"{name}.{n}", 0.0), e)
        # the stage's parameters in the kernel's layout (w1, b1, g1, be1,
        # w2, b2, g2, be2), before the step
        params = [t.detach() for t in (
            bb.conv1.weight.t(), bb.conv1.bias, bb.bn1.scale, bb.bn1.bias,
            bb.conv2.weight.t(), bb.conv2.bias, bb.bn2.scale, bb.bn2.bias)]
        # popped: the output's hook holds ``rec``, a cycle that would keep
        # the kernel's tensors alive through the step timings that follow
        u, v, bn1, out, slot = rec.pop("kernel")
        with torch.no_grad():
            mask1 = _kernel_mask1(u, v, bn1, rec["idx"])[0]
        exact = _branch_grads(rec["x"], rec["idx"], params, rec["dout"],
                              mask1, slot.long(), out > 0)[1:]
        # the model's gradients in the kernel's layout and order
        mine = [grads[f"{name}.{n}"] for n in _KERNEL_LAYOUT]
        mine = [g.t() if g.dim() == 2 else g for g in mine]
        by_kernel_name = et.grad_errors(mine, exact, et.GRAD_NAMES[1:],
                                        et.ABSORBED)
        branch.update((f"{name}.{n}", by_kernel_name[k])
                      for n, k in _KERNEL_LAYOUT.items())
        del exact, mask1
        torch.cuda.empty_cache()
    return errs, sens, branch


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
    # 10 launches of kernel 5 per backbone per step (stats1, fwd, select
    # and two reduces forward; bwd2, bwd_mid, bwd_in and two reduces
    # backward), 3 backbones a step;
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
            edge_errs, edge_sens, edge_exact = _edge_layer_errors(
                tr.model, snapshot, seen)
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
    worst_exact = max(edge_exact, key=edge_exact.get)
    print(f"DGCNN first step, fused vs unfused: loss {lf:.7f} vs {lu:.7f} "
          f"(rel gap {abs(lf - lu) / abs(lu):.2e}, rtol {STEP_LOSS_RTOL}); "
          f"worst gradient rel L2 error {errs[worst]:.2e} ({worst}; tol "
          f"{STEP_GRAD_TOL} or {STEP_SENS_FACTOR:g} x its largest gap "
          f"under noise, {STEP_SENS_FACTOR * sens[worst]:.2e})")
    print(f"DGCNN first step, edge layers (conv1/bn1/conv2/bn2) fused vs "
          f"unfused under the fused stages' cotangents: worst gradient rel "
          f"L2 error {edge_errs[worst_edge]:.2e} ({worst_edge}; tol "
          f"{STEP_GRAD_TOL} or {STEP_SENS_FACTOR:g} x the unfused layers' "
          f"largest gap under noise, "
          f"{STEP_SENS_FACTOR * edge_sens[worst_edge]:.2e}); "
          + ", ".join(f"{n_}={v:.1e}" for n_, v in edge_errs.items()))
    print(f"DGCNN first step, edge layers fused vs float64 on the kernel's "
          f"branch, same cotangents: worst gradient rel L2 error "
          f"{edge_exact[worst_exact]:.2e} ({worst_exact}; tol "
          f"{STEP_GRAD_TOL})")
    print(f"DGCNN training step, {PAIRS} pairs (host clock, ends in a "
          f"synchronize): fused {msf:.1f} ms, unfused {msu:.1f} ms; peak "
          f"device memory fused {pkf / 2**30:.2f} GiB, unfused "
          f"{pku / 2**30:.2f} GiB")
    check(max(edge_exact.values()) <= STEP_GRAD_TOL,
          "the fused edge layers' gradients differ from float64 on the "
          "kernel's branch")
    check(all(e <= max(STEP_GRAD_TOL, STEP_SENS_FACTOR * edge_sens[n_])
              for n_, e in edge_errs.items()),
          "fused and unfused edge layers' gradients differ")
    check(abs(lf - lu) <= max(STEP_LOSS_RTOL * abs(lu),
                              STEP_SENS_FACTOR * loss_sens),
          "fused and unfused first-step losses differ")
    check(all(errs[n_] <= max(STEP_GRAD_TOL, STEP_SENS_FACTOR * sens[n_])
              for n_ in names),
          "fused and unfused first-step gradients differ")
    return counts


def _dp_config_file(basedir: str, basepath: str, name: str,
                    **training) -> str:
    """TRAIN_CONFIG with the fused edge stage for one epoch on the generated
    dataset, written to ``basedir/name.json`` (the CLI logs its run to
    ``basedir/name``); ``training`` overrides keys of its training block."""
    with open(TRAIN_CONFIG) as f:
        d = json.load(f)
    d["data"]["basepath"] = basepath
    d["logging"] = {"basedir": basedir}
    d["model"]["options"]["dgcnn_fused_train"] = True
    d["training"]["num_epochs"] = 1
    d["training"].update(training)
    path = os.path.join(basedir, f"{name}.json")
    os.makedirs(basedir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _dp_step(cfg_path: str, batch, rows=None):
    """One training step of a fresh Trainer on the card (``rows`` of the
    batch: this process's): (loss, state_dict on the CPU, the Trainer)."""
    from alignnet3d_tpu_torch.config import load_config
    from alignnet3d_tpu_torch.training.trainer import Trainer

    tr = Trainer(load_config(cfg_path), seed=SEED, device="cuda")
    tr.init_state()
    mine = batch if rows is None else tuple(a[rows] for a in batch)
    metrics = tr.train_step(mine)
    torch.cuda.synchronize()
    return (float(metrics["losses/loss"]),
            {k: v.detach().cpu().clone() for k, v in
             tr.model.state_dict().items()}, tr, mine)


@contextlib.contextmanager
def _planted(fault: str):
    """Kernel 5's backward with one of DP_FAULTS in this process:
    ``dg_dbeta_reduced_twice`` also all-reduces the BN scales' and shifts'
    gradients, which DistributedDataParallel then reduces again;
    ``sa1_sb1_not_reduced`` skips the all-reduce of the first BN's
    gradient sums (the backward's second)."""
    from alignnet3d_tpu_torch.ops.edge_train_kernels import (
        _FusedEdgeStageTrain as fn,
    )
    from alignnet3d_tpu_torch.parallel import multihost

    backward, reduce_ = fn.backward, multihost.all_reduce_

    def faulty(ctx, *cotangents):
        if fault == "sa1_sb1_not_reduced":
            calls = []

            def skip_second(t):
                calls.append(t)
                return t if len(calls) == 2 else reduce_(t)

            multihost.all_reduce_ = skip_second
            try:
                return backward(ctx, *cotangents)
            finally:
                multihost.all_reduce_ = reduce_
        grads = list(backward(ctx, *cotangents))
        for i in (4, 5, 8, 9):  # g1, be1, g2, be2
            grads[i] = reduce_(grads[i].clone())
        return tuple(grads)

    assert fault in DP_FAULTS, fault
    fn.backward = staticmethod(faulty)
    try:
        yield
    finally:
        fn.backward = staticmethod(backward)


def _dp_step_worker(rank: int, ranks: int, rdzv: str, cfg_path: str, batch,
                    out_dir: str):
    """Process ``rank`` of a DP_RANKS run on the one card over gloo: its
    rows of the global batch through one step, then DP_STEP_ITERS timed
    steps, then one step from the initial state with each of DP_FAULTS
    planted; writes (loss, state, ms, the faults' states) to
    ``out_dir/rank<r>.pt``."""
    from alignnet3d_tpu_torch.parallel import multihost

    multihost.maybe_initialize(rdzv, ranks, rank, backend="gloo")
    try:
        local = len(batch[0]) // ranks
        loss, state, tr, mine = _dp_step(
            cfg_path, batch, slice(rank * local, (rank + 1) * local))
        ms, _ = _step_ms(tr, mine, DP_STEP_ITERS)
        del tr
        faults = {}
        for fault in DP_FAULTS:
            with _planted(fault):
                _, faults[fault], tr, _ = _dp_step(
                    cfg_path, batch, slice(rank * local, (rank + 1) * local))
            del tr
        torch.save({"loss": loss, "state": state, "ms": ms,
                    "faults": faults},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _state_gap(a: dict, b: dict, keys) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in keys)


def data_parallel_phase(basepath: str, workdir: str, card: str):
    """Data-parallel training of the fused DGCNN (TRAIN_CONFIG, full width,
    batch PAIRS) through ``parallel/multihost.py``: (a) one process on NCCL
    through the CLI with the ALIGNNET_* variables, against the
    non-distributed run of the same seed (``dgcnn_training_phase``'s);
    (b) DP_RANKS processes on the one card over gloo with CUDA tensors,
    PAIRS / DP_RANKS rows each: the first step (momentum SGD) against one
    process's step on the same global batch, an epoch through the CLI
    (equal parameters on every process, each process's launches of kernels
    3 and 5), eval_only of its checkpoint against one process's eval.
    Returns the launch counts of the processes' runs, summed by kernel."""
    from alignnet3d_tpu_torch.config import load_config
    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.parallel import dryrun
    from alignnet3d_tpu_torch.training.trainer import Trainer
    from alignnet3d_tpu_torch.weights import init_state_dict

    t_phase = time.perf_counter()
    basedir = os.path.join(workdir, "dp")
    total = dict.fromkeys(_wrappers(), 0)

    def add(results):
        for r in results:
            for name, n in r["launches"].items():
                total[name] += n

    # (a) world size 1 on NCCL, against the run of dgcnn_training_phase
    one = _dp_config_file(basedir, basepath, "nccl1")
    t0 = time.perf_counter()
    res = dryrun.run_workers(1, ["train", "--config", one, "--device",
                                 "cuda"], dryrun.file_rendezvous(basedir),
                             timeout=300)
    add(res)
    check(res[0]["backend"] == "nccl", f"backend {res[0]['backend']}")
    got = torch.load(os.path.join(basedir, "nccl1", "model-0.pt"),
                     map_location="cpu", weights_only=True)["model"]
    want = torch.load(os.path.join(workdir, "dgcnn_fused", "model-0.pt"),
                      map_location="cpu", weights_only=True)["model"]
    names = list(want)
    equal = all(torch.equal(got[k], want[k]) for k in names)

    def step_losses(logdir):
        with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
            return [json.loads(line)["losses/loss"] for line in f]

    ref = step_losses(os.path.join(workdir, "dgcnn_fused"))
    nccl = step_losses(os.path.join(basedir, "nccl1"))
    gaps = [abs(x - y) / abs(y) for x, y in zip(nccl, ref)]
    print(f"DP (a): 1 process on NCCL through the CLI vs the "
          f"non-distributed epoch: parameters bit-equal {equal}, largest gap "
          f"{_state_gap(got, want, names):.3e}; step losses {nccl} vs {ref}, "
          f"rel gaps {[f'{g:.2e}' for g in gaps]} (limits {DP_SAME_RTOL} on "
          f"the first steps); {time.perf_counter() - t0:.1f} s; launches "
          f"{res[0]['launches']}")
    check(len(nccl) == len(ref) >= len(DP_SAME_RTOL) and all(
        g <= lim for g, lim in zip(gaps, DP_SAME_RTOL)),
        "the 1-process NCCL run differs from the non-distributed run")

    # (b) the first step: DP_RANKS processes against one on the same batch
    step_cfg = _dp_config_file(basedir, basepath, "step", optimizer={
        "optimizer": "momentum", "momentum": 0.9})
    train_idx = getDataFiles(os.path.join(basepath, "split", "train.txt"))
    spec = ModelSpec.from_config(load_config(step_cfg))
    batch = PackedDataset(basepath).sample_batch(
        train_idx[:PAIRS], spec.num_points, np.random.default_rng(SEED + 6))
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(
        _dp_step_worker, nprocs=DP_RANKS, join=True,
        args=(DP_RANKS, dryrun.file_rendezvous(basedir), step_cfg, batch,
              basedir))
    ranks = [torch.load(os.path.join(basedir, f"rank{r}.pt"),
                        weights_only=True) for r in range(DP_RANKS)]
    print(f"DP (b): {DP_RANKS} processes' first step on the card over gloo: "
          f"{time.perf_counter() - t0:.1f} s")
    for r in ranks[1:]:
        check(all(torch.equal(r["state"][k], ranks[0]["state"][k])
                  for k in names) and r["loss"] == ranks[0]["loss"],
              "the processes' states differ after the first step")
    init = init_state_dict(spec, SEED)
    lw, want, tr, _ = _dp_step(step_cfg, batch)
    ms_one, _ = _step_ms(tr, batch, DP_STEP_ITERS)
    del tr
    rng = np.random.default_rng(SEED + 9)
    loss_sens, sens = 0.0, dict.fromkeys(names, 0.0)
    params = [k for k in names if not k.endswith((".mean", ".var"))]
    upd = lambda s: [s[k] - init[k] for k in params]  # noqa: E731
    for _ in range(STEP_SENS_DRAWS):
        lp, sp, tr, _ = _dp_step(step_cfg, tuple(
            (a * (1.0 + STEP_SENS_REL * rng.standard_normal(a.shape))).astype(
                np.float32) if i < 2 else a for i, a in enumerate(batch)))
        del tr
        s = et.grad_errors(upd(sp), upd(want), params,
                           _absorbed_biases(params))
        loss_sens = max(loss_sens, abs(lp - lw))
        sens = {k: max(sens.get(k, 0.0), s[k]) for k in params}
    bound = {k: max(STEP_GRAD_TOL, STEP_SENS_FACTOR * sens[k])
             for k in params}

    def held(state):
        """The worst update's (name, rel L2 error, error / its bound)."""
        errs = et.grad_errors(upd(state), upd(want), params,
                              _absorbed_biases(params))
        worst = max(params, key=lambda k: errs[k] / bound[k])
        return worst, errs[worst], errs[worst] / bound[worst]

    got = ranks[0]["state"]
    lg = ranks[0]["loss"]
    worst, err, ratio = held(got)
    sizes = sorted(float(u.abs().mean()) for u in upd(want))
    stats = [k for k in names if k.endswith((".mean", ".var"))]
    stats_ok = all(torch.allclose(got[k], want[k], rtol=DP_RTOL, atol=DP_ATOL)
                   for k in stats)
    print(f"DP (b) first step vs 1 process on the same {PAIRS} pairs: loss "
          f"{lg:.7f} vs {lw:.7f} (rel gap {abs(lg - lw) / abs(lw):.2e}, "
          f"rtol {DP_LOSS_RTOL}); mean |update| per parameter from "
          f"{sizes[0]:.2e} to {sizes[-1]:.2e} (median "
          f"{sizes[len(sizes) // 2]:.2e}); worst update rel L2 error "
          f"{err:.2e} ({worst}; {ratio:.3f} of its bound, {STEP_GRAD_TOL} or "
          f"{STEP_SENS_FACTOR:g} x its gap under {STEP_SENS_REL:g} input "
          f"noise); BN running statistics within rtol {DP_RTOL} / atol "
          f"{DP_ATOL}: {stats_ok}")
    print(f"DP (b) fused DGCNN step (host clock, {DP_STEP_ITERS} steps ending "
          f"in a synchronize): {DP_RANKS} x {PAIRS // DP_RANKS} rows on one "
          f"card over gloo {ranks[0]['ms']:.1f} ms (rank 0), "
          f"{ranks[1]['ms']:.1f} ms (rank 1); 1 x {PAIRS} rows "
          f"{ms_one:.1f} ms ({card})")
    check(abs(lg - lw) <= max(DP_LOSS_RTOL * abs(lw),
                              STEP_SENS_FACTOR * loss_sens),
          "DP first-step loss differs from the 1-process step")
    check(stats_ok, "DP BN running statistics differ from the 1-process step")
    check(ratio <= 1.0, "DP first-step parameters differ from the 1-process "
          "step")
    for fault in DP_FAULTS:
        worst, err, ratio = held(ranks[0]["faults"][fault])
        print(f"DP (b) first step with the fault {fault} planted in kernel "
              f"5's backward: worst update rel L2 error {err:.2e} ({worst}; "
              f"{ratio:.1f} x its bound)")
        check(ratio > 1.0, f"the DP step check passed the planted fault "
              f"{fault}")

    # (b) an epoch and eval_only through the CLI, DP_RANKS processes
    ep = _dp_config_file(basedir, basepath, "gloo2")
    cli = ["--config", ep, "--device", "cuda"]
    t0 = time.perf_counter()
    res = dryrun.run_workers(DP_RANKS, ["train", *cli],
                             dryrun.file_rendezvous(basedir),
                             backend="gloo", timeout=300)
    t_train = time.perf_counter() - t0
    add(res)
    steps = len(train_idx) // PAIRS
    for r in res:
        lc = r["launches"]
        print(f"DP (b) epoch, process {r['rank']}: launches {lc}")
        check(lc["fused_edge_stage_train"] == 30 * steps,
              f"process {r['rank']}: kernel 5 launched "
              f"{lc['fused_edge_stage_train']} times, expected {30 * steps}")
        check(lc["knn_points"] == 3 * steps + 3,
              f"process {r['rank']}: kernel 3 launched {lc['knn_points']} "
              f"times, expected {3 * steps + 3}")
    check(len({r["params"] for r in res}) == 1,
          "the processes' parameters differ after the epoch")
    logdir = os.path.join(basedir, "gloo2")
    _check_trained(logdir, "DP DGCNN")
    for r in range(1, DP_RANKS):
        check(os.listdir(os.path.join(logdir, f"proc{r}")) == ["out.log"],
              f"process {r} wrote more than its log")
    shutil.copytree(logdir, logdir + "_one")
    t0 = time.perf_counter()
    add(dryrun.run_workers(DP_RANKS, ["eval_only", "--eval_epoch", "0",
                                      *cli], dryrun.file_rendezvous(basedir),
                           backend="gloo", timeout=300))
    t_eval = time.perf_counter() - t0
    cfg = load_config(ep)
    cfg.logging.__dict__["logdir"] = logdir + "_one"
    one = Trainer(cfg, seed=SEED, device="cuda")
    one.train(eval_only=True, eval_epoch=0)
    ev = os.path.join("val", "eval000000")
    dp, ref = ([np.load(os.path.join(d, ev, f"{name}.npy")) for name in (
        "pred_translations", "pred_s2_pc1centers", "pred_angles")]
        for d in (logdir, logdir + "_one"))
    gap = _answer_gap(*dp[:2], dp[2][:, 0], *ref[:2], ref[2][:, 0])
    # the pairs whose answer rounding decides, on the 1-process model and
    # its eval batch (one batch of PAIRS)
    val = list(one.val_indices)
    check(len(val) == PAIRS, f"{len(val)} val pairs, expected {PAIRS}")
    batch = one._make_batch(val, rng=one._epoch_rng(2))
    ties, sensitive = decided_pairs(
        lambda a, b: one.eval_step((a, b, *batch[2:]))[1], batch[0],
        batch[1], one.spec.num_bins, np.pi / one.spec.num_bins
        if cfg.evaluation.scale_residuals else 1.0,
        cfg.evaluation.resolve_flips)
    aside = ties | sensitive
    ok = gap <= NET_ATOL
    print(f"DP (b) train {t_train:.1f} s, eval_only {t_eval:.1f} s through "
          f"the CLI; eval vs 1 process on its checkpoint: max gap "
          f"{gap[~aside].max():.3e} over {int((~aside).sum())} pairs (atol "
          f"{NET_ATOL}), {float((gap <= 1e-5).mean()):.1%} of {len(gap)} "
          f"within 1e-5; {int(ties.sum())} pairs at a near-tie, "
          f"{int(sensitive.sum())} moved > {NET_ATOL} by a {SENS_REL:g} "
          f"input perturbation; of those {int((~ok & aside).sum())} differ "
          f"(max gap {gap.max():.3e})")
    check(ok[~aside].all(), "DP eval predictions differ from the 1-process "
          "eval")
    check(ties.mean() <= 0.05, "DP eval: too many near-ties")
    check(sensitive.mean() <= SENS_SHARE,
          "DP eval: too many rounding-sensitive pairs")
    print(f"data-parallel phase: {time.perf_counter() - t_phase:.1f} s; "
          f"launches of its processes {total}")
    return total


def _model_step(spec, loss_spec, state, batch, device):
    """Loss and parameter gradients of one train-mode forward of AlignNet
    with ``state`` (dropout keep 1, no jitter), on ``device``."""
    from alignnet3d_tpu_torch.models.alignnet import AlignNet
    from alignnet3d_tpu_torch.models.backbones import Dropout
    from alignnet3d_tpu_torch.models.losses import get_loss

    model = AlignNet(spec).to(device).train()
    model.load_state_dict(state)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.keep = 1.0
    tb = [torch.from_numpy(a).to(device) for a in batch]
    loss, _ = get_loss(*tb, model(tb[0], tb[1], momentum=0.5),
                       spec=loss_spec)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), [g.cpu() for g in grads], list(params)


def model_options_phase(basepath: str, card: str):
    """One training step (loss and gradients) of the unfolded model on the
    card against the CPU, from the same seeded weights and batch:
    ``tpu.compute_dtype`` bfloat16 for the PointNet (CONFIG) and the fused
    DGCNN (TRAIN_CONFIG), ``stack_siamese=False`` for the PointNet in
    float32. Held to a tolerance (OPTION_TOL) or STEP_SENS_FACTOR times the
    card's own largest gap when its input points move by a relative
    OPTION_SENS (below one bf16 step for bf16), over OPTION_DRAWS draws; a
    gradient's error is taken relative to the larger of its norm and
    OPTION_FLOOR of the whole gradient's (BN-absorbed biases: of their BN
    shift's)."""
    import dataclasses

    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.models.losses import LossSpec

    t_phase = time.perf_counter()
    ds = PackedDataset(basepath)
    train = getDataFiles(os.path.join(basepath, "split", "train.txt"))
    cases = (("PointNet bf16", CONFIG, {"compute_dtype": "bfloat16"}, {}),
             ("fused DGCNN bf16", TRAIN_CONFIG,
              {"compute_dtype": "bfloat16", "dgcnn_fused_train": True}, {}),
             ("PointNet stack_siamese=False", CONFIG, {},
              {"stack_siamese": False}))
    for name, path, over, spec_over in cases:
        cfg = train_config(path, basepath, os.path.join(basepath, "unused"),
                           tpu={k: v for k, v in over.items()
                                if k == "compute_dtype"},
                           **{k: v for k, v in over.items()
                              if k != "compute_dtype"})
        spec = dataclasses.replace(ModelSpec.from_config(cfg), **spec_over)
        loss_spec = LossSpec.from_config(cfg)
        state = seeded_weights(spec)
        bf16 = spec.compute_dtype == "bfloat16"
        tol, sens_rel = OPTION_TOL[bf16], OPTION_SENS[bf16]
        batch = ds.sample_batch(train[:OPTION_PAIRS], spec.num_points,
                                np.random.default_rng(SEED + 10))
        lg, gg, names = _model_step(spec, loss_spec, state, batch, "cuda")
        t0 = time.perf_counter()
        lc, gc, _ = _model_step(spec, loss_spec, state, batch, "cpu")
        cpu_s = time.perf_counter() - t0
        absorbed = _absorbed_biases(names)
        floor = OPTION_FLOOR * float(torch.sqrt(sum(
            torch.sum(torch.square(r)) for r in gc)))
        norms = {n: max(float(r.norm()), floor) for n, r in zip(names, gc)}
        scale = {n: norms[absorbed.get(n, n)] for n in names}

        def rel(got, ref):
            return {n: float((g - r).norm()) / scale[n]
                    for n, g, r in zip(names, got, ref)}

        errs = rel(gg, gc)
        rng = np.random.default_rng(SEED + 11)
        loss_sens, sens = 0.0, dict.fromkeys(names, 0.0)
        for _ in range(OPTION_DRAWS):
            lp, gp, _ = _model_step(spec, loss_spec, state, tuple(
                (a * (1.0 + sens_rel * rng.standard_normal(a.shape))).astype(
                    np.float32) if i < 2 else a for i, a in enumerate(batch)),
                "cuda")
            s = rel(gp, gg)
            loss_sens = max(loss_sens, abs(lp - lg))
            sens = {n: max(sens[n], s[n]) for n in names}
        worst = max(errs, key=lambda n: errs[n] / max(
            tol, STEP_SENS_FACTOR * sens[n]))
        print(f"{name} first step, {OPTION_PAIRS} pairs, card vs CPU (CPU "
              f"{cpu_s:.1f} s): loss {lg:.7f} vs {lc:.7f} (rel gap "
              f"{abs(lg - lc) / abs(lc):.2e}); worst gradient rel L2 error "
              f"{errs[worst]:.2e} ({worst}; tol {tol} or "
              f"{STEP_SENS_FACTOR:g} x its gap under {sens_rel:g} input "
              f"noise, {STEP_SENS_FACTOR * sens[worst]:.2e})")
        check(abs(lg - lc) <= max(tol * abs(lc),
                                  STEP_SENS_FACTOR * loss_sens),
              f"{name}: card and CPU first-step losses differ")
        check(all(errs[n] <= max(tol, STEP_SENS_FACTOR * sens[n])
                  for n in names),
              f"{name}: card and CPU first-step gradients differ")
    print(f"model options phase: {time.perf_counter() - t_phase:.1f} s")


def int8_phase(spec, state, requests, card: str):
    """``build_inference_fn(quantize=...)`` at PAIRS pairs, both scopes, on
    the card against the CPU (each output's relative L2 gap within
    INT8_REL), and the folded forward timed by CUDA events in float32,
    bf16 and int8. Returns the launch counts of one int8 forward of each
    scope (the chains it leaves in float32 run kernel 1)."""
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.serving import build_inference_fn

    t_phase = time.perf_counter()
    probe = Aligner(spec, state, batch_size=PAIRS, seed=SEED, device="cpu")
    a_np, b_np = (probe._resample(p) for p in requests[0])
    a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
    wrappers = _wrappers()
    total = dict.fromkeys(wrappers, 0)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        fn = build_inference_fn(spec, state, dtype, device="cuda")
        times[str(dtype).split(".")[-1]] = cuda_ms(lambda: fn(a, b))
    f32 = build_inference_fn(spec, state, device="cuda")(a, b)
    for scope in ("embedding", "backbones"):
        fn = build_inference_fn(spec, state, device="cuda", quantize=scope)
        times[f"int8 {scope}"] = cuda_ms(lambda: fn(a, b))
        for w in wrappers.values():
            w.launches = 0
        got = fn(a, b)
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            total[n] += c
        want_k1 = 2 if scope == "embedding" else 0
        check(counts["fused_pointnet"] == want_k1,
              f"int8 {scope}: fused_pointnet launched "
              f"{counts['fused_pointnet']} times, expected {want_k1}")
        cpu = build_inference_fn(spec, state, device="cpu", quantize=scope)(
            torch.from_numpy(a_np), torch.from_numpy(b_np))
        gaps, vs_f32 = {}, {}
        for key, v in got.items():
            g, c, f = v.cpu().double(), cpu[key].double(), f32[key].cpu(
            ).double()
            check(bool(torch.isfinite(g).all()), f"int8 {scope}: {key} "
                  f"is not finite")
            gaps[key] = float((g - c).norm() / c.norm().clamp_min(1e-12))
            vs_f32[key] = float((g - f).norm() / f.norm().clamp_min(1e-12))
        worst = max(gaps, key=gaps.get)
        print(f"int8 {scope}, {PAIRS} pairs: card vs CPU worst rel L2 gap "
              f"{gaps[worst]:.2e} ({worst}; limit {INT8_REL}); vs the f32 "
              f"forward on the card up to {max(vs_f32.values()):.2e}; "
              f"launches {counts}")
        check(gaps[worst] <= INT8_REL, f"int8 {scope}: card and CPU differ")
    print(f"PointNet folded forward, {PAIRS} pairs (CUDA events; {card}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    print(f"int8 phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def _kernel_class(name: str) -> str:
    if "gemm" in name or "xmma" in name or "cutlass" in name:
        return "matmul"
    for key in ("reduce", "elementwise"):
        if key in name:
            return key
    return "other"


def trace_busy(path: str):
    """(window ms, device-busy ms, kernel ms by class: matmul, reduce,
    elementwise, other) of a ``torch.profiler`` Chrome trace: the window
    spans every timed event, and the card is busy where a kernel, memcpy
    or memset runs (their union, so overlapping streams count once).
    (window, None, {}) when the trace holds no device activity."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    window = (max(e["ts"] + e["dur"] for e in events) - t0) / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return window, None, {}
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_class = {}
    for e in events:
        if e.get("cat") == "kernel":
            c = _kernel_class(e["name"])
            by_class[c] = by_class.get(c, 0.0) + e["dur"] / 1e3
    return window, busy / 1e3, by_class


def _print_trace(model: str, trainer, card: str):
    """Check that tpu.profile wrote one trace of steps 1-PROFILE_STEPS and
    print its device-busy share; returns the card's busy ms a step (None
    when the trace holds no device activity)."""
    name = f"train_epoch0_steps1-{PROFILE_STEPS}.json"
    check(len(trainer.profile_traces) == 1
          and trainer.profile_traces[0].endswith(name)
          and os.path.isfile(trainer.profile_traces[0]),
          f"{model}: tpu.profile wrote {trainer.profile_traces}")
    window, busy, by_class = trace_busy(trainer.profile_traces[0])
    if busy is None:
        print(f"{model} tpu.profile trace of steps 1-{PROFILE_STEPS}: "
              f"{window:.1f} ms window; device activity not measured (the "
              f"trace holds no kernel)")
        return None
    print(f"{model} tpu.profile trace of steps 1-{PROFILE_STEPS} "
          f"(torch.profiler, {card}): window {window:.1f} ms, the card busy "
          f"{busy:.1f} ms ({busy / window:.1%} under the profiler), idle "
          f"{window - busy:.1f} ms; kernel ms by class "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              by_class.items(), key=lambda kv: -kv[1])))
    return busy / PROFILE_STEPS


def _print_step(model: str, trainer, batch, device_ms, card: str):
    """The step's host-clock time and peak memory without the profiler, and
    the share of it that the trace's device time a step fills."""
    step_ms, peak = _step_ms(trainer, batch)
    share = (f"; the trace's {device_ms:.1f} ms of device time a step is "
             f"{device_ms / step_ms:.0%} of it" if device_ms else "")
    print(f"{model} training step, {PAIRS} pairs at N="
          f"{trainer.spec.num_points} (host clock, ends in a synchronize; "
          f"{card}): {step_ms:.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB{share}")


def pointnet_training_phase(basepath: str, workdir: str, card: str):
    """One epoch (3 steps + eval) of the PointNet at SynthCars width, with
    a tpu.profile trace of steps 1-PROFILE_STEPS."""
    from alignnet3d_tpu_torch.training.trainer import Trainer

    logdir = os.path.join(workdir, "pointnet")
    trainer = Trainer(train_config(CONFIG, basepath, logdir, tpu={
        "profile": {"dir": os.path.join(workdir, "pointnet_trace"),
                    "steps": PROFILE_STEPS}}), seed=SEED, device="cuda")
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    print(f"PointNet training, 1 epoch (3 steps of {PAIRS} pairs + eval "
          f"of {PAIRS}, steps 1-{PROFILE_STEPS} under the profiler): "
          f"{time.perf_counter() - t0:.1f} s")
    _check_trained(logdir, "PointNet")
    device_ms = _print_trace("PointNet", trainer, card)
    train = trainer.train_indices[:PAIRS]
    batch = trainer.dataset.sample_batch(train, trainer.spec.num_points,
                                         np.random.default_rng(SEED + 6))
    _print_step("PointNet", trainer, batch, device_ms, card)


def loader_phase(basepath: str, card: str):
    """(a) The port's native batch assembler: built by g++ from
    ``csrc/loader.cpp`` and loaded (a run without it fails here); on the
    generated dataset, ``sample_batch`` of PAIRS training pairs by its
    default (native) path held bit-equal to the numpy twin of
    ``resample_gather`` on the seeds it drew, at each N of LOADER_POINTS;
    and the host time of a batch, native against the numpy path. Full
    size: the training batch of the configs at N=512 and N=1024."""
    from alignnet3d_tpu_torch.data import native_loader
    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles

    t0 = time.perf_counter()
    lib = native_loader.get_lib()
    build_s = time.perf_counter() - t0
    check(lib is not None, "the native batch assembler did not build or load")
    check(os.path.realpath(lib._name)
          == os.path.realpath(native_loader.library_path()),
          f"the loaded assembler is {lib._name}, not the port's")
    print(f"native batch assembler built by g++ and loaded in {build_s:.1f} s "
          f"({native_loader.library_path().name})")
    ds = PackedDataset(basepath)
    idx = getDataFiles(f"{basepath}/split/train.txt")[:PAIRS]
    rows = ds.rows(idx)
    for n in LOADER_POINTS:
        rng = np.random.default_rng(SEED + n)
        batch = ds.sample_batch(idx, n, rng)
        seeds = np.random.default_rng(SEED + n).integers(0, 2 ** 63, 2)
        for k in (1, 2):
            twin = native_loader.resample_gather_plain(
                getattr(ds, f"points{k}"), getattr(ds, f"offsets{k}"),
                getattr(ds, f"counts{k}"), rows, n, int(seeds[k - 1]))
            check(np.array_equal(batch[k - 1], twin),
                  f"sample_batch at N={n}: pc{k} differs from the numpy twin")
        times = {}
        for path, native in (("native", True), ("numpy", False)):
            ms = []
            for r in range(LOADER_REPEATS):
                rng = np.random.default_rng(r)
                t0 = time.perf_counter()
                ds.sample_batch(idx, n, rng, use_native=native)
                ms.append((time.perf_counter() - t0) * 1e3)
            times[path] = float(np.median(ms))
        print(f"sample_batch of {PAIRS} pairs at N={n} (host clock, median "
              f"of {LOADER_REPEATS}; {card}'s host): native {times['native']:.3f}"
              f" ms, numpy {times['numpy']:.3f} ms "
              f"({times['numpy'] / times['native']:.1f}x); bit-equal to the "
              f"numpy twin of the assembler")


def _step_vs_cpu(cfg, batch, model: str):
    """The first training step's loss and gradients on the card and on the
    CPU from the same seeded weights and batch (no jitter, dropout keep 1),
    held to STEP_GRAD_TOL (relative L2 per parameter) or STEP_SENS_FACTOR
    times the card's largest gap under STEP_SENS_DRAWS perturbations of
    the input points by STEP_SENS_REL: the completion chamfer's minima and
    the yaw bins' argmax are discrete choices rounding can flip."""
    from alignnet3d_tpu_torch.models.backbones import Dropout
    from alignnet3d_tpu_torch.ops import edge_train_kernels as et
    from alignnet3d_tpu_torch.training.trainer import Trainer

    def step(device, b):
        tr = Trainer(cfg, seed=SEED, device=device)
        tr.init_state()
        tr._jitter = lambda pcs: pcs
        for mod in tr.model.modules():
            if isinstance(mod, Dropout):
                mod.keep = 1.0
        loss, grads = _first_step_grads(tr, b)
        names = [n for n, _ in tr.model.named_parameters()]
        return loss, [g.cpu() for g in grads], names

    lg, gg, names = step("cuda", batch)
    t0 = time.perf_counter()
    lc, gc, _ = step("cpu", batch)
    cpu_s = time.perf_counter() - t0
    absorbed = _absorbed_biases(names)
    errs = et.grad_errors(gg, gc, names, absorbed)
    rng = np.random.default_rng(SEED + 8)
    loss_sens, sens = 0.0, dict.fromkeys(names, 0.0)
    for _ in range(STEP_SENS_DRAWS):
        lp, gp, _ = step("cuda", tuple(
            (a * (1.0 + STEP_SENS_REL * rng.standard_normal(a.shape))).astype(
                np.float32) if i < 2 else a for i, a in enumerate(batch)))
        s = et.grad_errors(gp, gg, names, absorbed)
        loss_sens = max(loss_sens, abs(lp - lg))
        sens = {n: max(sens[n], s[n]) for n in names}
    worst = max(errs, key=errs.get)
    print(f"{model} first step, card vs CPU (CPU step {cpu_s:.1f} s): loss "
          f"{lg:.7f} vs {lc:.7f} (rel gap {abs(lg - lc) / abs(lc):.2e}); "
          f"worst gradient rel L2 error {errs[worst]:.2e} ({worst}; tol "
          f"{STEP_GRAD_TOL} or {STEP_SENS_FACTOR:g} x its largest gap on the "
          f"card under noise, {STEP_SENS_FACTOR * sens[worst]:.2e})")
    check(abs(lg - lc) <= max(STEP_LOSS_RTOL * abs(lc),
                              STEP_SENS_FACTOR * loss_sens),
          f"{model}: card and CPU first-step losses differ")
    check(all(errs[n] <= max(STEP_GRAD_TOL, STEP_SENS_FACTOR * sens[n])
              for n in names),
          f"{model}: card and CPU first-step gradients differ")


def _serve_run(logdir: str, pcs1, pcs2, model: str):
    """Serve a run through ``Aligner.from_checkpoint`` with flips; returns
    the kernels' launches during the request (the counts' growth)."""
    from alignnet3d_tpu_torch import api

    aligner = api.Aligner.from_checkpoint(
        os.path.join(logdir, "config.json"), os.path.join(logdir, "model-0.pt"),
        batch_size=PAIRS, seed=SEED)
    wrappers = _wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    t0 = time.perf_counter()
    out = aligner.align(pcs1, pcs2, resolve_flips=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches - before[name]
              for name, fn in wrappers.items()}
    check(out["transforms"].shape == (len(pcs1), 4, 4)
          and all(np.isfinite(v).all() for v in out.values()),
          f"{model} request: non-finite answer or wrong shape")
    expected = {"fused_pointnet": 3, "nn_argmin": 2}
    for name, want in expected.items():
        check(counts[name] == want, f"{model} request: {name} "
              f"{counts[name]} launches, expected {want}")
    print(f"{model} run served through Aligner.from_checkpoint, {len(pcs1)} "
          f"pairs with flips: {wall * 1e3:.1f} ms (host clock, first request "
          f"of a new Aligner); kernel launches {counts}")
    return {name: counts[name] for name in expected}


def completion_phase(basepath: str, workdir: str, card: str):
    """(b) The completion head: one epoch of configs/SynthCars40kComp.json at
    full width (PointNet, N=1024, completion_points 256, batch 128) on the
    generated dataset through ``Trainer.train()``, with tpu.profile set for
    steps 1-PROFILE_STEPS; its first step against the CPU from the same
    weights and batch; the step time and peak memory; the run served with
    flips through ``Aligner.from_checkpoint``. Launch counts are set to 0
    before the training and read after the request. Cut: 1 epoch of 384
    pairs, not 120 of 40k."""
    from alignnet3d_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    logdir = os.path.join(workdir, "completion")
    cfg = train_config(COMP_CONFIG, basepath, logdir, tpu={
        "profile": {"dir": os.path.join(workdir, "completion_trace"),
                    "steps": PROFILE_STEPS}})
    check(cfg.model.options.completion_points == 256
          and cfg.training.loss.options.completion_weight > 0
          and cfg.evaluation.resolve_flips, "SynthCars40kComp.json changed")
    trainer = Trainer(cfg, seed=SEED, device="cuda")
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"completion training (SynthCars40kComp width: PointNet N="
          f"{trainer.spec.num_points}, completion_points "
          f"{trainer.spec.completion_points}), 1 epoch (3 steps of {PAIRS} "
          f"pairs + eval of {PAIRS} with flips; cut: 1 epoch of 384 pairs, "
          f"not 120 of 40k): {wall:.1f} s; kernel launches {train_counts}")
    _check_trained(logdir, "completion")
    with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
        comp = [json.loads(line)["losses_stages/completion_loss"]
                for line in f]
    check(all(np.isfinite(comp)) and min(comp) > 0,
          f"completion losses {comp}")
    print(f"completion loss by step {[round(v, 4) for v in comp]}")
    check(train_counts["nn_argmin"] == 2,  # the eval batch's flips
          f"completion eval: nn_argmin {train_counts['nn_argmin']} launches")
    device_ms = _print_trace("completion", trainer, card)
    served = _serve_run(logdir, *_val_clouds(basepath), "completion")
    counts = {name: fn.launches for name, fn in wrappers.items()}
    check(all(counts[k] == train_counts[k] + served[k] for k in served),
          f"completion path: kernel launches {counts}")

    train = trainer.train_indices[:PAIRS]
    batch = trainer.dataset.sample_batch(train, trainer.spec.num_points,
                                         np.random.default_rng(SEED + 6))
    _print_step("completion", trainer, batch, device_ms, card)
    del trainer
    torch.cuda.empty_cache()
    _step_vs_cpu(train_config(COMP_CONFIG, basepath,
                              os.path.join(workdir, "completion_step")),
                 batch, "completion")
    print(f"completion phase: {time.perf_counter() - t_phase:.1f} s; "
          f"kernel launches of its training and request {counts}")
    return {name: counts[name] for name in served}


def make_kitti_tree(root: str, rng):
    """A synthetic KITTI tracking tree (velodyne scans and label_02 files,
    the layout kitti_generate reads): KITTI_SEQS sequences of KITTI_FRAMES
    frames, each frame KITTI_CLUTTER background points in a 60 m square
    plus the points of KITTI_CARS cars and one pedestrian, each track with
    its own lane, speed, yaw rate and point count."""
    from alignnet3d_tpu_torch.data import kitti

    tracks = [("Car", (1.5, 1.7, 4.0))] * KITTI_CARS + [
        ("Pedestrian", (1.7, 0.6, 0.8))]
    for seq in KITTI_SEQS:
        velo = os.path.join(root, "training", "velodyne", f"{seq:04d}")
        os.makedirs(velo)
        lanes = rng.uniform(-12.0, 12.0, len(tracks))
        depth = rng.uniform(6.0, 25.0, len(tracks))
        speed = rng.uniform(-0.6, 0.6, len(tracks))
        yaw0 = rng.uniform(-np.pi, np.pi, len(tracks))
        yaw_rate = rng.uniform(-0.03, 0.03, len(tracks))
        npts = rng.integers(150, 1500, len(tracks))
        lines = []
        for frame in range(KITTI_FRAMES):
            pts = [rng.uniform((-30, -30, -2), (30, 30, 2),
                               (KITTI_CLUTTER, 3))]
            for tid, (cls, (h, w, l)) in enumerate(tracks):
                x = lanes[tid] + speed[tid] * frame
                z = depth[tid]
                ry = yaw0[tid] + yaw_rate[tid] * frame
                lines.append(f"{frame} {tid} {cls} 0 0 -1.5 100 100 200 200 "
                             f"{h} {w} {l} {x} 1.5 {z} {ry}")
                R = kitti.roty(ry)
                local = rng.uniform(-0.45, 0.45, (npts[tid], 3)) * (l, h, w)
                centre = np.array([x, 1.5, z]) + R @ np.array([0, -h / 2, 0])
                pts.append((local @ R.T + centre) @ kitti.R_KITTI2GLOBAL)
            scan = np.concatenate(pts).astype(np.float32)
            np.concatenate([scan, np.ones((len(scan), 1), np.float32)],
                           axis=1).tofile(os.path.join(velo,
                                                       f"{frame:06d}.bin"))
        labels = os.path.join(root, "training", "label_02")
        os.makedirs(labels, exist_ok=True)
        with open(os.path.join(labels, f"{seq:04d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def make_held_dataset(root: str, out: str):
    """The val sequence's car tracks as a Held-style dataset (``data/held.py``
    FromHeldScene: consecutive observations with timestamps KITTI_DT apart),
    every pair in the val split."""
    from alignnet3d_tpu_torch.data import kitti
    from alignnet3d_tpu_torch.data.held import FromHeldScene

    seq = KITTI_SEQS[-1]
    labels = kitti.TrackingLabels(
        os.path.join(root, "training", "label_02", f"{seq:04d}.txt"))
    rows = [r for r in labels.rows if r["class"] == "Car"]
    scans = {}
    n = 0
    for tid in sorted({r["id"] for r in rows}):
        recs = sorted((r for r in rows if r["id"] == tid),
                      key=lambda r: r["frame"])
        for r1, r2 in zip(recs, recs[1:]):
            pcs = []
            for r in (r1, r2):
                if r["frame"] not in scans:
                    scans[r["frame"]] = kitti.load_velo_scan(os.path.join(
                        root, "training", "velodyne", f"{seq:04d}",
                        f"{r['frame']:06d}.bin"))
                pcs.append((kitti.extract_object_points(
                    scans[r["frame"]], kitti.TrackingLabels.boxvec(r)),
                    KITTI_DT * r["frame"]))
            FromHeldScene(tid, r1["frame"], r2["frame"], *pcs).save(out, n)
            n += 1
    os.makedirs(os.path.join(out, "split"), exist_ok=True)
    with open(os.path.join(out, "split", "train.txt"), "w") as f:
        f.write("")
    with open(os.path.join(out, "split", "val.txt"), "w") as f:
        f.write("\n".join(str(i) for i in range(n)) + "\n")
    return n


def kitti_phase(workdir: str, card: str):
    """(c) The KITTI toolchain: a synthetic KITTI tracking tree (no KITTI
    data in the repo) made into the KITTITrackletsCars dataset by the
    port's ``kitti_generate``; one epoch of configs/KITTITrackletsCars.json
    at full width (PointNet, N=512, batch 128) through the CLI, its
    ``training.pretraining.model`` the PointNet training phase's run (the
    config's own recipe: a SynthCars run); the run served with flips; then
    evaluation.special.mode 'held' with that run through the CLI on the val
    sequence's tracks written by ``FromHeldScene``, on the card and on the
    CPU. Launch counts are set to 0 before the training and read after the
    held evals. Cuts: 3 synthetic sequences of 33 frames, not KITTI's 21;
    1 epoch, not 200; the pretrained run 1 epoch of 384 pairs, not 180
    epochs."""
    from alignnet3d_tpu_torch import cli
    from alignnet3d_tpu_torch.data.kitti_generate import generate_kitti_dataset

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "kitti")
    tree = os.path.join(root, "tree")
    t0 = time.perf_counter()
    make_kitti_tree(tree, np.random.default_rng(SEED + 9))
    data = os.path.join(root, "KITTITrackletsCars")
    train_idx, val_idx = generate_kitti_dataset(tree, data)
    gen_s = time.perf_counter() - t0
    expected = KITTI_CARS * (KITTI_FRAMES - 1)
    check(len(train_idx) == 2 * expected and len(val_idx) == expected,
          f"kitti_generate: {len(train_idx)} train / {len(val_idx)} val pairs")
    sizes = [len(np.load(os.path.join(data, f"pointcloud{k}", f"{i:08d}.npy")))
             for i in val_idx for k in (1, 2)]
    print(f"KITTI: synthetic tracking tree ({len(KITTI_SEQS)} sequences x "
          f"{KITTI_FRAMES} frames, {KITTI_CARS} cars + 1 pedestrian a "
          f"sequence) and kitti_generate's KITTITrackletsCars dataset, "
          f"{len(train_idx)} train / {len(val_idx)} val pairs, in {gen_s:.1f} "
          f"s; points per val cloud {min(sizes)}-{max(sizes)}")

    with open(KITTI_CONFIG) as f:
        d = json.load(f)
    pretrained = os.path.join(workdir, "pointnet", "model-0")
    d["data"]["basepath"] = data
    d["logging"] = {"basedir": root}
    d["training"].update(num_epochs=1, pretraining={"model": pretrained})
    config = os.path.join(root, "KITTITrackletsCars.json")
    with open(config, "w") as f:
        json.dump(d, f)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = cli.main(["train", "--config", config, "--seed", str(SEED)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    logdir = os.path.join(root, "KITTITrackletsCars")
    steps = len(train_idx) // d["training"]["batch_size"]
    # the pretrained run's optimizer count (its 3 steps) carries on
    check(trainer.step == steps and trainer.schedule_count == 3 + steps,
          f"KITTI training: step {trainer.step}, optimizer count "
          f"{trainer.schedule_count}")
    with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["losses/loss"] for line in f]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"KITTI training losses {losses}")
    tables = {}
    for ev in ("eval0pretr", "eval000000"):
        with open(os.path.join(logdir, "val", ev, "eval.json")) as f:
            tables[ev] = json.load(f)
        check(tables[ev]["num"] == expected, f"KITTI {ev}: "
              f"{tables[ev]['num']} pairs")
    print(f"KITTI training through the CLI from the PointNet run, 1 epoch "
          f"({steps} steps of {PAIRS} pairs + the 'pretr' and epoch evals of "
          f"{expected}): {train_s:.1f} s (host clock, {card}); losses "
          f"{[round(v, 4) for v in losses]}; corr_levels pretr "
          f"{tables['eval0pretr']['corr_levels']}, epoch 0 "
          f"{tables['eval000000']['corr_levels']}")
    served = _serve_run(logdir, *_val_clouds(data), "KITTI")

    held_data = os.path.join(root, "HeldData")
    n_held = make_held_dataset(tree, held_data)
    preds, tracks = {}, {}
    for device in ("cuda", "cpu"):
        hd = dict(d, data={"basepath": held_data},
                  logging={"basedir": os.path.join(root, f"held_{device}")},
                  evaluation={"special": {"mode": "held",
                                          "held": {"model": logdir}}})
        path = os.path.join(root, f"held_{device}.json")
        with open(path, "w") as f:
            json.dump(hd, f)
        t0 = time.perf_counter()
        cli.main(["eval_only", "--config", path, "--eval_epoch", "0",
                  "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        held_s = time.perf_counter() - t0
        ev = os.path.join(root, f"held_{device}", f"held_{device}", "val",
                          "eval000000")
        preds[device] = np.load(os.path.join(ev, "pred_translations.npy"))
        tracks[device] = {f: np.loadtxt(os.path.join(ev, f))
                          for f in sorted(os.listdir(ev))
                          if f.startswith("track")}
        print(f"held mode through the CLI on the {device}, {n_held} pairs of "
              f"{len(tracks[device])} tracks: {held_s:.1f} s (host clock)")
    check(len(tracks["cuda"]) == KITTI_CARS
          and list(tracks["cuda"]) == list(tracks["cpu"])
          and all(len(v) == KITTI_FRAMES - 1 and np.isfinite(v).all()
                  for v in tracks["cuda"].values()),
          f"held tracks {[(k, len(v)) for k, v in tracks['cuda'].items()]}")
    agree = np.all(np.abs(preds["cuda"] - preds["cpu"]) <= NET_ATOL, axis=1)
    gap = max(float(np.max(np.abs(tracks["cuda"][k] - tracks["cpu"][k])))
              for k in tracks["cuda"])
    print(f"held, card vs CPU: translations within {NET_ATOL} m for "
          f"{agree.mean():.1%} of pairs (needs {ICP_AGREE:.0%}); largest "
          f"velocity gap {gap:.2e} m/s; mean speeds "
          + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in
                      tracks["cuda"].items()))
    check(agree.mean() >= ICP_AGREE, "held: card and CPU translations differ")
    counts = {name: fn.launches for name, fn in wrappers.items()}
    check(all(counts[k] == served[k] for k in served),
          f"KITTI path: kernel launches {counts}, expected the request's "
          f"{served} alone (no flips in the config's evals)")
    print(f"KITTI phase: {time.perf_counter() - t_phase:.1f} s; kernel "
          f"launches of its training, request and held evals {counts}")
    return served


def _refine_config(path: Path, basepath: str, basedir: str, name: str,
                   **training) -> str:
    """The config at ``path`` as ``basedir/name.json``: the generated
    dataset, one epoch, log directory ``basedir/name``, and ``training``
    keys overridden by ``training``."""
    with open(path) as f:
        d = json.load(f)
    d["data"]["basepath"] = basepath
    d["logging"] = {"basedir": basedir}
    d["training"]["num_epochs"] = 1
    d["training"].update(training)
    out = os.path.join(basedir, f"{name}.json")
    with open(out, "w") as f:
        json.dump(d, f)
    return out


def _refine_eval(cli, config: str, logdir: str, method: str, stages):
    """``eval_only --refineICP`` of epoch 0 through the CLI on the card, the
    launch counts set to 0 just before and read just after. Checks the
    eval files and nn_argmin's launches: 2 flip sweeps per eval batch in
    each of the two network passes, and per gated ICP stage and chunk of
    PAIRS pairs its iterations + 1 (fitness) + 1 (the gate's score)."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = cli.main(["eval_only", "--config", config, "--refineICP",
                        "--eval_epoch", "0", "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    ev = os.path.join(logdir, "val", "eval000000", f"refined_{method}")
    names = ["eval.json", "eval_180.json"] + [f"pred_{k}.npy" for k in (
        "translations", "angles", "s1_pc1centers", "s1_pc2centers",
        "s2_pc1centers", "s2_pc2centers", "s2_pc1angles", "s2_pc2angles")]
    for name in names:
        check(os.path.isfile(os.path.join(ev, name)),
              f"{config}: no refined_{method}/{name}")
    for name in names[2:]:
        arr = np.load(os.path.join(ev, name))
        check(arr.shape[0] == PAIRS and np.isfinite(arr).all(),
              f"{config}: refined_{method}/{name} is not finite")
    n_val = len(trainer.val_indices)
    batches = -(-n_val // trainer.batch_size)
    chunks = -(-n_val // PAIRS)
    expected = 2 * 2 * batches + sum((its + 2) * chunks for its in stages)
    with open(os.path.join(ev, "eval.json")) as f:
        levels = json.load(f)["corr_levels"]
    times = trainer.eval_times
    print(f"{Path(config).stem} eval_only --refineICP ({method}, stages of "
          f"{list(stages)} iterations) over {n_val} val pairs: "
          f"{wall:.2f} s wall (load, network, refine, files); network refine "
          f"{times['network_refine']:.3f} s, ICP per stage "
          f"{[round(s, 3) for s in times['icp_stages']]} s; corr_levels "
          f"{levels}; kernel launches {counts}")
    check(counts["nn_argmin"] == expected,
          f"{config}: nn_argmin {counts['nn_argmin']} launches, expected "
          f"{expected}")
    return counts["nn_argmin"]


def _pose_errors(t, a, world_t, gt_a):
    """World-frame translation error (m) and yaw error (deg) per pair."""
    return (np.linalg.norm(t - world_t, axis=1),
            np.degrees(_angle_gap(np.asarray(a).reshape(-1), gt_a)))


def refinement_phase(basepath: str, workdir: str):
    """The eval-time stack at full width: (a) one epoch (3 steps + the
    eval with the second network pass) of the PointNet of
    ``configs/SynthCars80kFullStack.json`` with its voxel view, through the
    CLI; (b) ``eval_only --refineICP`` of those weights with that config
    (network refine, gated p2plane ICP) and with
    ``configs/SynthCars80kNetRefineCascade.json`` (network refine, a
    2-stage gated p2p cascade), counting launches; (c) ICP from the ground
    truth perturbed by up to REFINE_PERTURB, both methods, gate on: all
    PAIRS val pairs on the card, REFINE_CPU_PAIRS of them on the CPU.
    Returns the nn_argmin launches of (b)."""
    from alignnet3d_tpu_torch import cli
    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles
    from alignnet3d_tpu_torch.geometry import (
        translate_transform_to_new_center_of_rotation,
    )
    from alignnet3d_tpu_torch.icp import (
        estimate_normals_batch,
        refine_predictions,
    )
    from alignnet3d_tpu_torch.icp.p2point import pad_full_clouds

    t_phase = time.perf_counter()
    basedir = os.path.join(workdir, "refine")
    os.makedirs(basedir)
    full = _refine_config(FULLSTACK_CONFIG, basepath, basedir, "fullstack")
    cascade = _refine_config(CASCADE_CONFIG, basepath, basedir, "cascade")
    t0 = time.perf_counter()
    trainer = cli.main(["train", "--config", full, "--seed", str(SEED)])
    torch.cuda.synchronize()
    print(f"FullStack training through the CLI, 1 epoch (3 steps of {PAIRS} "
          f"pairs + eval of {PAIRS} with network refine): "
          f"{time.perf_counter() - t0:.1f} s")
    _check_trained(os.path.join(basedir, "fullstack"), "FullStack")
    check(trainer.dataset._vox_size == 0.05, "FullStack: no voxel view")
    # the cascade evaluates the same weights: the two configs share a model
    os.makedirs(os.path.join(basedir, "cascade"))
    shutil.copy(os.path.join(basedir, "fullstack", "model-0.pt"),
                os.path.join(basedir, "cascade", "model-0.pt"))
    launches = _refine_eval(cli, full, os.path.join(basedir, "fullstack"),
                            "p2plane", [30])
    launches += _refine_eval(cli, cascade, os.path.join(basedir, "cascade"),
                             "p2p", [30, 20])

    ds = PackedDataset(basepath)
    val = getDataFiles(f"{basepath}/split/val.txt")[:PAIRS]
    rows = ds.rows(val)
    rng = np.random.default_rng(SEED + 11)
    n = len(val)
    gt_t = ds.translations[rows].reshape(n, 3)
    gt_a = ds.rel_angles[rows].reshape(n)
    gt_c = ds.pc1centers[rows].reshape(n, 3)
    pred_t = (gt_t + rng.uniform(-1, 1, (n, 3)) * [1, 1, 0]
              * REFINE_PERTURB[1]).astype(np.float32)
    pred_a = (gt_a + np.deg2rad(rng.uniform(-1, 1, n) * REFINE_PERTURB[0])
              ).astype(np.float32).reshape(n, 1)
    pred_c = gt_c.astype(np.float32)
    zero = np.zeros_like(gt_c)
    world = translate_transform_to_new_center_of_rotation(gt_t, gt_a, gt_c,
                                                          zero)
    init_err = _pose_errors(translate_transform_to_new_center_of_rotation(
        pred_t, pred_a, gt_c, zero), pred_a, world, gt_a)
    _, (dst, dst_mask) = pad_full_clouds(ds, val)
    normals_ms = cuda_ms(lambda: estimate_normals_batch(
        dst, dst_mask, device="cuda"), iters=3, warmup=1)
    print(f"p2plane normals (k=16) of {n} clouds padded to {dst.shape[1]} "
          f"points: {normals_ms:.2f} ms (CUDA events, host inputs)")
    m = REFINE_CPU_PAIRS
    # both sides refine in chunks of m pairs: pad_full_clouds subsamples a
    # cloud above 4096 points from one generator per chunk, in pair order,
    # so the card's first chunk and the CPU's one chunk draw the same
    # subsamples only when the chunks are the same pairs; and both pad to
    # one length
    pad = pad_full_clouds(ds, val[:m])[1][0].shape[1]
    check(pad == dst.shape[1], f"the first {m} pairs pad to {pad} points, "
          f"all {n} to {dst.shape[1]}: the card and the CPU would see other "
          f"clouds")
    for method in ("p2p", "p2plane"):
        kwargs = dict(its=ICP_ITS, radius=0.1, dataset=ds, gate=True,
                      method=method, pair_chunk=m)
        gpu, gpu_s = refine_predictions(None, val, pred_t, pred_a, pred_c,
                                        device="cuda", **kwargs)
        t0 = time.perf_counter()
        cpu, _ = refine_predictions(None, val[:m], pred_t[:m], pred_a[:m],
                                    pred_c[:m], device="cpu", **kwargs)
        cpu_s = time.perf_counter() - t0
        dt = np.linalg.norm(gpu["translations"][:m] - cpu["translations"],
                            axis=1)
        da = np.degrees(_angle_gap(gpu["angles"][:m, 0], cpu["angles"][:, 0]))
        agree = (dt <= ICP_TOL[0]) & (da <= ICP_TOL[1])
        err = _pose_errors(gpu["translations"], gpu["angles"], world, gt_a)
        print(f"ICP {method} from the truth perturbed by up to "
              f"{REFINE_PERTURB[0]} deg / {REFINE_PERTURB[1]} m, gate on, "
              f"{ICP_ITS} its at radius 0.1: card {n} pairs in {gpu_s:.3f} s "
              f"(accepted {int(gpu['accepted'].sum())}), CPU {m} pairs in "
              f"{cpu_s:.1f} s; card vs CPU within {ICP_TOL[0]} m and "
              f"{ICP_TOL[1]} deg: {agree.mean():.1%}, gate decisions equal "
              f"{(gpu['accepted'][:m] == cpu['accepted']).mean():.1%}; "
              f"median error init {np.median(init_err[0]):.4f} m "
              f"{np.median(init_err[1]):.3f} deg, refined "
              f"{np.median(err[0]):.4f} m {np.median(err[1]):.3f} deg")
        check(agree.mean() >= ICP_AGREE,
              f"ICP {method}: card and CPU answers disagree")
        check(np.median(err[0]) < np.median(init_err[0])
              and np.median(err[1]) < np.median(init_err[1]),
              f"ICP {method}: the refined median error is not below the "
              f"init's")
    print(f"refinement phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _same_tree(got: dict, want: dict, path: str = "") -> int:
    """Leaves of two state trees, bit-equal in value, dtype and shape;
    returns their count."""
    check(got.keys() == want.keys(), f"state tree {path}: keys differ")
    n = 0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            n += _same_tree(g, w, f"{path}/{key}")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape
              and np.array_equal(g, w), f"state leaf {path}/{key} differs")
        n += 1
    return n


def _val_clouds(basepath: str):
    from alignnet3d_tpu_torch.data.provider import getDataFiles

    val = getDataFiles(f"{basepath}/split/val.txt")[:PAIRS]
    return tuple([np.load(os.path.join(basepath, f"pointcloud{k}",
                                       f"{i:08d}.npy")) for i in val]
                 for k in (1, 2))


def trained_runs_phase(basepath: str, workdir: str, card: str):
    """Runs across the two packages, at the width of
    ``configs/SynthCars80kRefiner.json`` (the FullStack model's): (a) the
    refinement phase's FullStack run written as the JAX layout
    ``model-0.msgpack`` and read back bit-equal, and
    ``Aligner.from_checkpoint`` of the ``.pt`` and of the ``.msgpack``
    answering PAIRS val pairs bit-equal; (b) one epoch of the Refiner
    config through the CLI, ``pretraining.model`` the ``.msgpack`` run
    without its suffix, the residual task on; (c) the two-stage request,
    coarse + refiner (flips, network refine, ICP), with the launch counts
    set to 0 just before and read just after, held against the CPU on the
    same inputs: the network stage on all PAIRS pairs (so that both draw
    the same resamples), ICP on REFINE_CPU_PAIRS of them from the card's
    inits. Returns the launch counts of (c)."""
    from alignnet3d_tpu_torch import api, checkpoint, cli
    from alignnet3d_tpu_torch.config import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import AlignNet, ModelSpec
    from alignnet3d_tpu_torch.training import schedules

    t_phase = time.perf_counter()
    fullstack = os.path.join(workdir, "refine", "fullstack")
    basedir = os.path.join(workdir, "trained")
    coarse = os.path.join(basedir, "coarse")
    os.makedirs(coarse)
    config = os.path.join(coarse, "config.json")
    shutil.copy(os.path.join(fullstack, "config.json"), config)
    with open(config) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))

    # (a) the port's run in the JAX layout, and back
    pt = os.path.join(fullstack, "model-0.pt")
    packed = os.path.join(coarse, "model-0.msgpack")
    model = AlignNet(spec)
    opt = torch.optim.Adam(model.parameters())
    restored = checkpoint.load(pt, model, opt)
    t0 = time.perf_counter()
    checkpoint.save(packed, model, opt, restored["step"],
                    restored["schedule_count"])
    back = checkpoint.read_msgpack(packed)
    rw_s = time.perf_counter() - t0
    leaves = _same_tree(back, checkpoint.train_state_tree(
        model, opt, restored["step"], restored["schedule_count"]))
    again = AlignNet(spec)
    again_opt = torch.optim.Adam(again.parameters())
    check(checkpoint.load(packed, again, again_opt) == restored,
          f"the .msgpack run restores another step or count than {restored}")
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        check(torch.equal(a, b), f"{k}: the .msgpack weights differ")
    check(len(opt.state) == len(again_opt.state) == len(
        list(model.parameters())), "the runs hold no Adam state")
    for p, q in zip(model.parameters(), again.parameters()):
        for key, a in opt.state[p].items():
            check(torch.equal(a, again_opt.state[q][key]),
                  f"Adam {key}: the .msgpack state differs")
    check(restored["schedule_count"] == restored["step"] > 0,
          f"the FullStack run's counts {restored}")
    print(f"FullStack run as the JAX TrainState model-0.msgpack: {leaves} "
          f"leaves, {os.path.getsize(packed) / 2**20:.1f} MiB, written and "
          f"read in {rw_s:.2f} s (host); step and optimizer count "
          f"{restored['step']}; every leaf, weight and Adam moment bit-equal")

    pcs1, pcs2 = _val_clouds(basepath)
    answers = [api.Aligner.from_checkpoint(config, path, batch_size=PAIRS,
                                           seed=SEED).align(
        pcs1, pcs2, resolve_flips=True) for path in (pt, packed)]
    for key, value in answers[0].items():
        check(np.array_equal(value, answers[1][key]),
              f"from_checkpoint: .pt and .msgpack answers differ in {key}")
    print(f"Aligner.from_checkpoint of the .pt and the .msgpack, {PAIRS} val "
          f"pairs with flips on the card: answers bit-equal")

    # (b) the refiner: one epoch of the residual task from the .msgpack run
    refiner_cfg = _refine_config(
        REFINER_CONFIG, basepath, basedir, "refiner",
        pretraining={"model": os.path.join(coarse, "model-0")})
    t0 = time.perf_counter()
    trainer = cli.main(["train", "--config", refiner_cfg, "--seed",
                        str(SEED)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    logdir = os.path.join(basedir, "refiner")
    _check_trained(logdir, "Refiner")
    check(os.path.isfile(os.path.join(logdir, "val", "eval0pretr",
                                      "eval.json")),
          "Refiner: no 'pretr' eval of the restored run")
    check(trainer._residual_params is not None, "Refiner: no residual task")
    nbpe = trainer.num_batches_per_epoch
    check(trainer.step == nbpe
          and trainer.schedule_count == restored["schedule_count"] + nbpe,
          f"Refiner: step {trainer.step}, optimizer count "
          f"{trainer.schedule_count}, coarse count "
          f"{restored['schedule_count']}")
    with open(os.path.join(logdir, "train", "scalars.jsonl")) as f:
        logged = [json.loads(line)["hyperparameters/learning_rate"]
                  for line in f]
    applied = [schedules.learning_rate(restored["schedule_count"] + s,
                                       trainer.cfg, nbpe) for s in range(nbpe)]
    print(f"Refiner training through the CLI from the .msgpack run, 1 epoch "
          f"({nbpe} steps of {PAIRS} pairs + the 'pretr' and epoch evals): "
          f"{train_s:.1f} s (host clock, {card}); optimizer count "
          f"{restored['schedule_count']} -> {trainer.schedule_count}; "
          f"learning rates applied {applied}, logged {logged}")

    # (c) the two-stage request, coarse + refiner
    refiner = checkpoint.state_dict_from_file(
        os.path.join(logdir, "model-0"), "cuda")
    kwargs = dict(resolve_flips=True, network_refine=True, refine_icp=True)
    aligner = api.Aligner.from_checkpoint(config, packed, batch_size=PAIRS,
                                          seed=SEED)
    aligner.align(pcs1, pcs2, refine_variables=refiner, **kwargs)  # warm-up
    rng_state = aligner._rng.bit_generator.state
    seen = {}
    gate, icp = api.compose_gated_refinement, api.icp_p2point_batch

    def gate_spy(*args, **kw):
        seen["gate"] = gate(*args, **kw)
        return seen["gate"]

    def icp_spy(*args, **kw):
        seen["icp_in"] = (args, kw)
        seen["icp"] = icp(*args, **kw)
        return seen["icp"]

    wrappers = _wrappers()
    api.compose_gated_refinement, api.icp_p2point_batch = gate_spy, icp_spy
    try:
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = aligner.align(pcs1, pcs2, refine_variables=refiner, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in wrappers.items()}
        gpu_gate, gpu_icp_in, gpu_icp = seen["gate"], seen["icp_in"], \
            seen["icp"]
        cpu = api.Aligner.from_checkpoint(config, packed, batch_size=PAIRS,
                                          device="cpu")
        cpu._rng.bit_generator.state = rng_state
        t0 = time.perf_counter()
        cpu.align(pcs1, pcs2, refine_variables=checkpoint
                  .state_dict_from_file(os.path.join(logdir, "model-0")),
                  resolve_flips=True, network_refine=True)
        cpu_net_s = time.perf_counter() - t0
        cpu_gate = seen["gate"]
    finally:
        api.compose_gated_refinement, api.icp_p2point_batch = gate, icp
    check(all(np.isfinite(v).all() for v in out.values())
          and out["transforms"].shape == (PAIRS, 4, 4),
          "two-stage request: non-finite answer or wrong shape")
    batches = -(-PAIRS // aligner.batch_size)
    expected = {"fused_pointnet": 3 * batches * 2,
                "nn_argmin": 2 * batches * 2 + ICP_ITS + 1}
    for name, want in expected.items():
        check(counts[name] == want,
              f"two-stage request: {name} {counts[name]} launches, expected "
              f"{want}")

    m = REFINE_CPU_PAIRS
    args, kw = gpu_icp_in
    t0 = time.perf_counter()
    cpu_tf, _, _ = icp(*(a[:m] for a in args), **dict(kw, device="cpu"))
    cpu_icp_s = time.perf_counter() - t0

    def agree(Ma, Mb):
        dt = np.linalg.norm(Ma[:, :3, 3] - Mb[:, :3, 3], axis=1)
        da = np.degrees(_angle_gap(np.arctan2(Ma[:, 1, 0], Ma[:, 0, 0]),
                                   np.arctan2(Mb[:, 1, 0], Mb[:, 0, 0])))
        return (dt <= ICP_TOL[0]) & (da <= ICP_TOL[1])

    same_gate = gpu_gate[1][:m] == cpu_gate[1][:m]
    net_agree = agree(gpu_gate[0][:m], cpu_gate[0][:m])
    icp_agree = agree(gpu_icp[0][:m], cpu_tf)
    print(f"two-stage request (coarse .msgpack + refiner, flips, network "
          f"refine, ICP {ICP_ITS} its), {PAIRS} val pairs: {wall * 1e3:.1f} "
          f"ms (host clock, ends in a synchronize; {card}); network refine "
          f"accepted {int(gpu_gate[1].sum())}/{PAIRS}; kernel launches "
          f"{counts}")
    print(f"two-stage request, card vs CPU on the first {m} pairs: gate "
          f"decisions equal {same_gate.mean():.1%}; network-stage poses "
          f"within {ICP_TOL[0]} m and {ICP_TOL[1]} deg {net_agree.mean():.1%}"
          f"; ICP from the card's inits {icp_agree.mean():.1%} (CPU network "
          f"stage of {PAIRS} pairs {cpu_net_s:.1f} s, ICP of {m} pairs "
          f"{cpu_icp_s:.1f} s)")
    check(same_gate.all(), "two-stage request: card and CPU gate decisions "
          "differ")
    check(net_agree.mean() >= ICP_AGREE and icp_agree.mean() >= ICP_AGREE,
          "two-stage request: card and CPU poses disagree")
    print(f"trained-runs phase: {time.perf_counter() - t_phase:.1f} s")
    return {name: counts[name] for name in expected}


def _baseline_configs(data_root: str, runs: str, cfg_dir: str):
    """The classical-baseline configs as make_icp_configs.py writes them
    (its SynthCars ones, pointed at ``data_root/SynthCars``), plus
    multistart, logging under ``runs``: {variant name: path}."""
    import make_icp_configs

    make_icp_configs.main(basedir=cfg_dir, data_root=data_root)
    paths = {}
    for vname, icp in list(make_icp_configs.VARIANTS.items()) + [
            ("multistart", {"variant": "multistart"})]:
        path = os.path.join(cfg_dir, f"icp_SynthCars_{vname}.json")
        d = {"data": {"basepath": f"{data_root}/SynthCars"},
             "evaluation": {"special": {"mode": "icp", "icp": {
                 "with_constraint": True, **icp}}}}
        if os.path.isfile(path):
            with open(path) as f:
                d = json.load(f)
        d["logging"] = {"basedir": runs}
        with open(path, "w") as f:
            json.dump(d, f)
        paths[vname] = path
    return paths


def _baseline_preds(runs: str, vname: str):
    ev = os.path.join(runs, "icp_SynthCars", f"icp_SynthCars_{vname}", "val",
                      "eval000000")
    return tuple(np.load(os.path.join(ev, f"pred_{k}.npy")) for k in
                 ("translations", "angles", "s1_pc1centers")), ev


def _pose_agree(t1, a1, t2, a2):
    """Per pair: translations within ICP_TOL[0] m and yaws within
    ICP_TOL[1] degrees."""
    dt = np.linalg.norm(t1 - t2, axis=1)
    da = np.degrees(_angle_gap(a1.reshape(-1), a2.reshape(-1)))
    return (dt <= ICP_TOL[0]) & (da <= ICP_TOL[1])


def _run_baselines(cli, paths, device: str, counts: bool = False,
                   variants=BASELINE_ORDER):
    """Each of ``variants`` through ``alignnet3d_tpu_torch.cli train
    --config``, in eval_icp.sh's order; with ``counts``, nn_argmin's
    launches set to 0 just before each run and read just after, and the
    card's peak memory. Returns {variant: (seconds, launches, peak
    bytes)}."""
    from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin

    # the runner logs both eval dicts of every run; this script prints its
    # own summary
    log = logging.getLogger("alignnet3d_tpu_torch")
    level = log.level
    log.setLevel(logging.WARNING)
    out = {}
    try:
        for vname in variants:
            if counts:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                nn_argmin.launches = 0
            t0 = time.perf_counter()
            cli.main(["train", "--config", paths[vname], "--device", device])
            if counts:
                torch.cuda.synchronize()
            out[vname] = (time.perf_counter() - t0, nn_argmin.launches,
                          torch.cuda.max_memory_allocated() if counts else 0)
    finally:
        log.setLevel(level)
    return out


def _copy_pairs(basepath: str, dest: str, idxs):
    """A dataset at ``dest`` whose val split holds the pairs ``idxs`` of
    ``basepath`` (their files copied under the same indices)."""
    for sub in ("meta", "pointcloud1", "pointcloud2", "split"):
        os.makedirs(os.path.join(dest, sub))
    for i in idxs:
        for sub, ext in (("meta", "json"), ("pointcloud1", "npy"),
                         ("pointcloud2", "npy")):
            shutil.copy(os.path.join(basepath, sub, f"{i:08d}.{ext}"),
                        os.path.join(dest, sub, f"{i:08d}.{ext}"))
    with open(os.path.join(dest, "split", "val.txt"), "w") as f:
        f.write("\n".join(str(i) for i in idxs) + "\n")
    open(os.path.join(dest, "split", "train.txt"), "w").close()


def _recovery(clouds, device: str):
    """Each cloud registered against itself moved by RECOVERY_MOTION, by
    FPFH + RANSAC and by FPFH + FGR, each refined by p2p ICP as the
    ``*_p2p`` variants refine (30 iterations, radius 0.1). Returns
    {variant: (median point error per cloud, seconds)}."""
    from alignnet3d_tpu_torch.geometry import get_mat_angle, transform_points
    from alignnet3d_tpu_torch.icp.fpfh import global_registration_batch
    from alignnet3d_tpu_torch.icp.p2point import icp_p2point_batch

    src, mask = clouds
    gt = get_mat_angle(*RECOVERY_MOTION)
    dst = np.stack([transform_points(c, gt) for c in src]).astype(np.float32)
    out = {}
    for vname, method in (("o3_gicp_p2p", "ransac"),
                          ("o3_gicp_fast_p2p", "fgr")):
        t0 = time.perf_counter()
        tf, _, _ = global_registration_batch(src, mask, dst, mask,
                                             method=method, device=device)
        # the runner stores (t, yaw) and refines from get_mat_angle of them
        init = np.stack([get_mat_angle(m[:3, 3].astype(np.float32),
                                       np.float32(np.arctan2(m[1, 0],
                                                             m[0, 0])))
                         for m in tf])
        tf, _, _ = icp_p2point_batch(src, mask, dst, mask, init, radius=0.10,
                                     its=30, device=device)
        seconds = time.perf_counter() - t0
        err = np.array([np.median(np.linalg.norm(
            transform_points(s[m], M) - d[m], axis=1))
            for s, d, m, M in zip(src, dst, mask, tf)])
        out[vname] = (err, seconds)
    return out


def multistart_nn_shape(basepath: str, val):
    """Kernel 2 at the multistart variant's coarse shape: the PAIRS val
    pairs padded to 4,096 points, each source moved by 8 yaw hypotheses
    about its centroid (8 x PAIRS clouds), against its destination; bit-equal
    to its twin. Returns (err, ms, plain ms, bound ms, bound by)."""
    from alignnet3d_tpu_torch.data.provider import PackedDataset
    from alignnet3d_tpu_torch.icp.p2point import pad_full_clouds
    from alignnet3d_tpu_torch.ops import nn_kernels as nk

    (src, sm), (dst, dm) = pad_full_clouds(PackedDataset(basepath), val)
    c1 = (src * sm[..., None]).sum(1) / np.maximum(sm.sum(1), 1)[:, None]
    moved = []
    for yaw in np.linspace(-np.pi, np.pi, 8, endpoint=False):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        moved.append((src - c1[:, None]) @ R.T + c1[:, None])
    a = torch.from_numpy(np.stack(moved, 1).reshape(-1, *src.shape[1:])
                         .astype(np.float32)).cuda()
    b = torch.from_numpy(np.repeat(dst, 8, axis=0)).cuda()
    m = torch.from_numpy(np.repeat(dm, 8, axis=0)).cuda()
    idx, d2 = nk.nn_argmin(a, b, m)
    ri, rd = nk.nn_argmin_plain(a, b, m)
    torch.cuda.synchronize()
    check(torch.equal(idx, ri) and torch.equal(d2, rd),
          "nn_argmin at the multistart shape is not bit-equal to its twin")
    err = float((d2 - rd).abs().max())
    ms = cuda_ms(lambda: nk.nn_argmin(a, b, m), iters=10)
    plain_ms = cuda_ms(lambda: nk.nn_argmin_plain(a, b, m), iters=1,
                       warmup=0)
    pairs = 8 * float((sm.sum(1).astype(np.float64) * dm.sum(1)).sum())
    nbytes = (a.numel() + b.numel()) * 4 + m.numel() + idx.numel() * 12
    result = (err, ms, plain_ms, *bound(9 * pairs, FP32_LANE_OPS, nbytes))
    print(f"nn_argmin multistart shape B={a.shape[0]} n1={a.shape[1]} "
          f"n2={b.shape[1]}: bit-equal, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {result[3]:.4f} ms ({result[4]})")
    return result


def _global_breakdown(basepath: str, val, card: str):
    """Where a chunk of the global registrations spends its time, on the
    PAIRS val pairs: the host's voxel downsample, the FPFH features of both
    sides, RANSAC and FGR (host clock, each ending in a synchronize)."""
    from alignnet3d_tpu_torch.data.provider import PackedDataset
    from alignnet3d_tpu_torch.icp import fgr, fpfh
    from alignnet3d_tpu_torch.icp.p2point import pad_full_clouds

    (src, sm), (dst, dm) = pad_full_clouds(PackedDataset(basepath), val)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    sp, smk, dp, dmk = timed("voxel downsample (host)", lambda: (
        *fpfh.prep_downsampled_batch(src, sm, 0.05),
        *fpfh.prep_downsampled_batch(dst, dm, 0.05)))
    sp, smk, dp, dmk = (torch.from_numpy(x).cuda() for x in (sp, smk, dp, dmk))
    sf, df = timed("FPFH both sides", lambda: (
        fpfh.fpfh_features_batch(sp, smk, 0.25)[0],
        fpfh.fpfh_features_batch(dp, dmk, 0.25)[0]))
    timed("RANSAC 2048 hypotheses", lambda: fpfh.ransac_registration_batch(
        sp, smk, dp, dmk, sf, df, 0.075))
    timed("FGR 64 iterations", lambda: fgr.fgr_batch(sp, smk, dp, dmk, sf, df))
    print(f"global registration of {len(val)} pairs, by stage: "
          f"{ {k: round(v, 3) for k, v in times.items()} } s; "
          f"{int(smk.sum())} + {int(dmk.sum())} downsampled points ({card})")


def baseline_phase(basepath: str, workdir: str, card: str):
    """The classical baselines (``evaluation.special.mode 'icp'``) at the
    generated dataset's full width: (a) the five variants of
    make_icp_configs.py and multistart through the CLI on the card over the
    PAIRS val pairs, in eval_icp.sh's order, counting nn_argmin's launches;
    (b) the same runner on a copy of the dataset that holds the first
    BASELINE_CPU_PAIRS of them (MULTISTART_CPU_PAIRS for multistart), on
    the card and on the CPU, compared pair by pair (the same chunk of
    pairs, so that pad_full_clouds draws the same subsamples of >4,096-point
    clouds on both); (c) recovery of
    RECOVERY_MOTION on the RECOVERY_CLOUDS largest val clouds by the two
    ``*_p2p`` pipelines, card against CPU; (d) kernel 2 at multistart's
    coarse shape. Returns (the launches of (a), (d)'s kernel row)."""
    from alignnet3d_tpu_torch import cli
    from alignnet3d_tpu_torch.data.provider import getDataFiles

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "baselines")
    val = getDataFiles(f"{basepath}/split/val.txt")[:PAIRS]
    sets = {}
    for name, pairs in (("card", None), ("card_few", BASELINE_CPU_PAIRS),
                        ("cpu_few", BASELINE_CPU_PAIRS),
                        ("card_ms", MULTISTART_CPU_PAIRS),
                        ("cpu_ms", MULTISTART_CPU_PAIRS)):
        data_root = os.path.join(root, name, "data")
        os.makedirs(data_root)
        if pairs is None:
            os.symlink(basepath, os.path.join(data_root, "SynthCars"))
        else:
            _copy_pairs(basepath, os.path.join(data_root, "SynthCars"),
                        val[:pairs])
        runs = os.path.join(root, name, "runs")
        sets[name] = (runs, _baseline_configs(data_root, runs, os.path.join(
            root, name, "configs")))

    # (a) the main path
    runs, paths = sets["card"]
    stats = _run_baselines(cli, paths, "cuda", counts=True)
    launches = 0
    for vname in BASELINE_ORDER:
        seconds, n_launch, peak = stats[vname]
        (t, a, c), ev = _baseline_preds(runs, vname)
        check(t.shape == (PAIRS, 3) and a.shape == (PAIRS, 1)
              and np.isfinite(t).all() and np.isfinite(a).all()
              and not c.any(), f"baseline {vname}: bad artifacts")
        with open(os.path.join(ev, "eval.json")) as f:
            d = json.load(f)
        buckets = {k: d[k]["corr_levels"] for k in
                   ("eval_5m", "eval_10m", "eval_15m", "eval_20m") if k in d}
        print(f"baseline {vname} through the CLI on the card, {PAIRS} val "
              f"pairs: mean_time {d['mean_time'] * 1e3:.3f} ms a pair "
              f"({seconds:.2f} s wall with loading, metrics and files); peak "
              f"device memory {peak / 2**30:.2f} GiB; nn_argmin launches "
              f"{n_launch}; corr_levels {d['corr_levels']}, by distance "
              f"{buckets}; mean error {d['mean_dist_translation']:.3f} m "
              f"{d['mean_dist_angle']:.2f} deg ({card})")
        check(n_launch == BASELINE_LAUNCHES[vname],
              f"baseline {vname}: nn_argmin {n_launch} launches, expected "
              f"{BASELINE_LAUNCHES[vname]}")
        launches += n_launch

    _global_breakdown(basepath, val, card)

    # (b) card vs CPU on the same pairs: multistart, whose CPU run costs
    # 8 x the others' (8 yaw hypotheses a pair), on fewer of them
    few = [v for v in BASELINE_ORDER if v != "multistart"]
    t0 = time.perf_counter()
    cpu = {}
    for tag, variants in (("few", few), ("ms", ["multistart"])):
        _run_baselines(cli, sets[f"card_{tag}"][1], "cuda", variants=variants)
        cpu.update(_run_baselines(cli, sets[f"cpu_{tag}"][1], "cpu",
                                  variants=variants))
    print(f"baselines on the CPU ({BASELINE_CPU_PAIRS} pairs, multistart "
          f"{MULTISTART_CPU_PAIRS}) and on the card again: "
          f"{time.perf_counter() - t0:.1f} s (CPU "
          f"{ {k: round(v[0], 1) for k, v in cpu.items()} } s)")
    for vname in BASELINE_ORDER:
        tag = "ms" if vname == "multistart" else "few"
        g = _baseline_preds(sets[f"card_{tag}"][0], vname)[0]
        c = _baseline_preds(sets[f"cpu_{tag}"][0], vname)[0]
        full = _baseline_preds(runs, vname)[0]
        m = len(g[0])
        agree = _pose_agree(g[0], g[1], c[0], c[1])
        chunk = _pose_agree(g[0], g[1], full[0][:m], full[1][:m])
        need = BASELINE_AGREE[vname]
        print(f"baseline {vname}, card vs CPU on {m} pairs within "
              f"{ICP_TOL[0]} m and {ICP_TOL[1]} deg: {agree.mean():.1%} "
              f"(needs {need:.0%}; pairs apart {np.flatnonzero(~agree)}); "
              f"the card's {m}-pair run vs its {PAIRS}-pair run "
              f"{chunk.mean():.1%} (a chunk of other pairs draws other "
              f"subsamples of >4,096-point clouds)")
        check(agree.mean() >= need, f"baseline {vname}: card and CPU "
              f"disagree on {int((~agree).sum())} of {m} pairs")

    # (c) recovery of a known motion
    clouds = [np.load(os.path.join(basepath, f"pointcloud{k}",
                                   f"{i:08d}.npy")) for i in val
              for k in (1, 2)]
    largest = sorted(range(len(clouds)), key=lambda i: -len(clouds[i]))
    rng = np.random.default_rng(SEED + 13)
    src, mask = _ragged([clouds[i] for i in largest[:RECOVERY_CLOUDS]],
                        4096, rng)
    rec = {dev: _recovery((src, mask), dev) for dev in ("cuda", "cpu")}
    for vname in rec["cuda"]:
        (eg, sg), (ec, sc) = rec["cuda"][vname], rec["cpu"][vname]
        ng, nc = int((eg < RECOVERY_TOL).sum()), int((ec < RECOVERY_TOL).sum())
        print(f"recovery of {np.degrees(RECOVERY_MOTION[1]):.1f} deg + "
              f"{RECOVERY_MOTION[0]} m by {vname}, the {RECOVERY_CLOUDS} "
              f"largest val clouds ({int(mask.sum(1).min())}-"
              f"{int(mask.sum(1).max())} points): median point error below "
              f"{RECOVERY_TOL} m on the card {ng}/{RECOVERY_CLOUDS} "
              f"({sg:.2f} s), on the CPU {nc}/{RECOVERY_CLOUDS} ({sc:.1f} "
              f"s); median of medians {np.median(eg):.4f} m")
        check(abs(ng - nc) <= 1, f"recovery {vname}: card {ng} and CPU {nc} "
              f"clouds recovered")
    k2 = multistart_nn_shape(basepath, val)
    print(f"baselines phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, k2


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


_ROUNDING_DECIDED = {}  # rounding_decided's answers, by request and model


def rounding_decided(spec, state, rng_state, pcs1, pcs2, flips: bool):
    """Pairs whose answer hangs on rounding, judged on the CPU run. Returns
    (ties, sensitive): ``ties`` are an argmax of yaw logits within
    TIE_MARGIN, or (with flips) chamfer scores of the two yaw hypotheses
    within TIE_MARGIN of each other; ``sensitive`` are pairs whose answer
    moves by more than NET_ATOL under a SENS_REL input perturbation. The
    answer for a request, a model and a generator state is computed once
    (the export phase asks again for the serving phases' first request)."""
    key = (spec, id(state), json.dumps(rng_state), id(pcs1), id(pcs2), flips)
    if key not in _ROUNDING_DECIDED:
        _ROUNDING_DECIDED[key] = _rounding_decided(spec, state, rng_state,
                                                   pcs1, pcs2, flips)
    return _ROUNDING_DECIDED[key]


def _rounding_decided(spec, state, rng_state, pcs1, pcs2, flips: bool):
    from alignnet3d_tpu_torch.api import Aligner

    probe = Aligner(spec, state, batch_size=PAIRS, device="cpu")
    probe._rng.bit_generator.state = rng_state
    a, b = probe._resample(pcs1), probe._resample(pcs2)

    def forward(pa, pb):
        return {k: v.numpy() for k, v in probe._forward(
            torch.from_numpy(pa), torch.from_numpy(pb)).items()}

    return decided_pairs(forward, a, b, spec.num_bins, probe.residual_scale,
                         flips)


def decided_pairs(forward, a, b, nb: int, residual_scale: float,
                  flips: bool):
    """``rounding_decided``'s (ties, sensitive) of the pairs (a, b) under
    ``forward(a, b)``, a model's end points as numpy."""
    from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
    from alignnet3d_tpu_torch.ops.flip_resolve import resolve_flips

    out = forward(a, b)
    flagged = np.zeros(len(a), bool)
    for key in ("pred_pc1angle_logits", "pred_pc2angle_logits",
                "pred_remaining_angle_logits"):
        flagged |= _top2_gap(out[key], nb) < TIE_MARGIN
    if flips:
        dec = decode_pair_outputs(out, a, b, nb, residual_scale,
                                  resolve_flips=False, device="cpu")
        _, d, d_flip = resolve_flips(
            torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(dec.translations),
            torch.from_numpy(dec.angles.astype(np.float32)),
            torch.from_numpy(dec.s2_pc1centers))
        d, d_flip = d.numpy(), d_flip.numpy()
        flagged |= np.abs(d - d_flip) <= TIE_MARGIN * np.maximum(d, d_flip)

    def answer(pa, pb, out):
        dec = decode_pair_outputs(out, pa, pb, nb, residual_scale,
                                  resolve_flips=flips, device="cpu")
        return dec.translations, dec.s2_pc1centers, dec.angles

    ref = answer(a, b, out)
    rng = np.random.default_rng(SEED + 4)
    sensitive = np.zeros(len(a), bool)
    for _ in range(SENS_DRAWS):
        pa, pb = ((x * (1.0 + SENS_REL * rng.standard_normal(x.shape)))
                  .astype(np.float32) for x in (a, b))
        sensitive |= _answer_gap(*ref, *answer(pa, pb, forward(pa, pb))) \
            > NET_ATOL
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


def _answers(spec, out, a, b):
    """Decoded (translations, centres, yaws) of a forward's outputs."""
    from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs

    dec = decode_pair_outputs({k: v.cpu().numpy() for k, v in out.items()},
                              a, b, spec.num_bins, 1.0, resolve_flips=False,
                              device="cpu")
    return dec.translations, dec.s2_pc1centers, dec.angles


def _exported_launches(infer, a, b):
    """The launch counts of one call of an exported program, set to 0 just
    before it and read just after."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = infer(a, b)
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in wrappers.items()}


def export_phase(specs, requests, card: str):
    """``alignnet3d_tpu_torch.export`` at the full widths of both models:
    artifacts exported on the card (PointNet f32 and bf16, DGCNN f32) and
    on the CPU, loaded from bytes; each held bit-equal to the eager
    ``build_inference_fn`` forward on the card at b = 1, 8 and PAIRS, its
    kernels' launches counted through the exported program; the card's
    f32 artifacts run on the CPU and held to the card outside the pairs
    that rounding decides; the exported and eager forwards timed at PAIRS
    pairs, and the plain and flips requests served again. Returns the
    launch counts of the exported programs' calls, by kernel."""
    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.export import (OUTPUT_KEYS,
                                             export_alignment_model,
                                             load_exported)
    from alignnet3d_tpu_torch.serving import build_inference_fn

    t_phase = time.perf_counter()
    owned = {"pointnet": ("fused_pointnet",),
             "dgcnn": ("knn_points", "fused_edge_stage")}
    cases = (("pointnet", torch.float32), ("pointnet", torch.bfloat16),
             ("dgcnn", torch.float32))
    pcs1, pcs2 = requests[0]
    total = dict.fromkeys(_wrappers(), 0)
    for model, dtype in cases:
        spec, state = specs[model]
        probe = Aligner(spec, state, batch_size=PAIRS, seed=SEED,
                        device="cpu")
        rng_state = probe._rng.bit_generator.state
        a_np, b_np = probe._resample(pcs1), probe._resample(pcs2)
        a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
        eager = build_inference_fn(spec, state, dtype, device="cuda")
        sources = [("card", "cuda")]
        if dtype == torch.float32:
            sources.append(("CPU", "cpu"))
        for where, device in sources:
            t0 = time.perf_counter()
            blob = export_alignment_model(spec, state, compute_dtype=dtype,
                                          device=device)
            t_export = time.perf_counter() - t0
            t0 = time.perf_counter()
            infer = load_exported(bytearray(blob), device="cuda")
            t_load = time.perf_counter() - t0
            print(f"export {model} {dtype} on the {where}: "
                  f"{t_export:.2f} s, {len(blob)} bytes; loaded on the card "
                  f"in {t_load:.2f} s")
            for n in (1, 8, PAIRS):
                got, counts = _exported_launches(infer, a[:n], b[:n])
                ref = eager(a[:n], b[:n])
                for key in OUTPUT_KEYS:
                    check(got[key].device.type == "cuda"
                          and torch.equal(got[key], ref[key]),
                          f"export {model} {dtype} ({where}) b={n}: {key} "
                          f"differs from the eager forward")
                for name in owned[model]:
                    check(counts[name] == 3,
                          f"export {model} {dtype} ({where}) b={n}: {name} "
                          f"launched {counts[name]} times, expected 3")
                for name, c in counts.items():
                    total[name] += c
            print(f"export {model} {dtype} ({where}): bit-equal to the eager "
                  f"forward at b = 1, 8, {PAIRS}; launches a call {counts}")
            if where != "card":
                continue
            if dtype == torch.float32:
                ms_exp = cuda_ms(lambda: infer(a, b))
                ms_eager = cuda_ms(lambda: eager(a, b))
                print(f"{model} forward, {PAIRS} pairs, {dtype}: exported "
                      f"{ms_exp:.4f} ms, eager {ms_eager:.4f} ms "
                      f"(CUDA events; {card})")
                on_cpu = load_exported(blob, device="cpu")
                cpu_ans = _answers(spec, on_cpu(a_np, b_np), a_np, b_np)
                card_ans = _answers(spec, infer(a, b), a_np, b_np)
                gap = _answer_gap(*card_ans, *cpu_ans)
                ties, sensitive = rounding_decided(spec, state, rng_state,
                                                   pcs1, pcs2, False)
                aside = ties | sensitive
                print(f"export {model} f32, the card's artifact on the CPU "
                      f"vs the card: max gap {gap[~aside].max():.3e} over "
                      f"{int((~aside).sum())} pairs (atol {NET_ATOL}); "
                      f"{int(aside.sum())} pairs set aside, of those "
                      f"{int((gap[aside] > NET_ATOL).sum())} differ")
                check((gap[~aside] <= NET_ATOL).all(),
                      f"export {model}: the card's artifact on the CPU "
                      f"disagrees with the card")
    # the PointNet plain and flips requests again, on a warm server
    kinds = REQUESTS[:2]
    aligner = Aligner(*specs["pointnet"], batch_size=PAIRS, seed=SEED + 2,
                      device="cuda")
    aligner.align(*requests[1], **kinds[1][1])
    _, walls, _ = serve(aligner, kinds, requests[:2], torch.cuda.synchronize)
    print("PointNet requests again: "
          + ", ".join(f"{name} {w * 1e3:.1f} ms"
                      for (name, _), w in zip(kinds, walls))
          + f" ({PAIRS} pairs, host clock; {card})")
    print(f"export phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def _scan_gaps(got, ref):
    """Per-point gaps of two scans of one ray grid, both in ray order:
    ray by ray where they hit the same number of rays, else each point's
    distance to the other scan's nearest (on the card, without cdist's
    matrix-product shortcut, which loses ~1e-2 m at 10 m)."""
    if len(got) == len(ref):
        return np.linalg.norm(got - ref, axis=1)
    g, r = (torch.from_numpy(np.asarray(x, np.float32)).cuda()
            for x in (got, ref))
    mode = "donot_use_mm_for_euclid_dist"
    return np.concatenate([
        torch.cat([torch.cdist(c, y, compute_mode=mode).amin(dim=1)
                   for c in x.split(4096)]).cpu().numpy()
        for x, y in ((g, r), (r, g))])


def generation_phase(workdir: str, spec, state, card: str):
    """The dataset CLI, ``python -m alignnet3d_tpu_torch.data.generate``:
    SynthCarsMesh at the default sensor (64 x 1500 rays), GEN_TRAIN +
    GEN_VAL scenes, through the port's g++ raycaster; 2 scenes' scans held
    against the numpy sweep; SynthCars through the CLI file-equal to a
    direct ``generate_dataset`` call; one request of PAIRS pairs with flips
    over the mesh dataset's val pairs (tiled) through ``Aligner.align``.
    Returns the request's launch counts."""
    import filecmp

    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.data import mesh_raycast as mr
    from alignnet3d_tpu_torch.data.synthetic import generate_dataset, lidar_rays

    t_phase = time.perf_counter()
    mesh_dir = os.path.join(workdir, "SynthCarsMesh")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "alignnet3d_tpu_torch.data.generate",
                    "SynthCarsMesh", "--out", mesh_dir, "--num_train",
                    str(GEN_TRAIN), "--num_val", str(GEN_VAL)],
                   cwd=ROOT, check=True, timeout=600)
    secs = time.perf_counter() - t0
    scenes = GEN_TRAIN + GEN_VAL
    print(f"SynthCarsMesh through the CLI: {scenes} scenes (64 x 1500 rays) "
          f"in {secs:.2f} s, {scenes / secs:.1f} scenes/s (host; {card})")
    check(mr.get_lib() is not None,
          "the port's native raycaster (csrc/raycast.cpp) did not build")

    # two scenes' scans, native against the numpy sweep: the CLI's library
    # (its default seed 0, 50 meshes) and each scene's mesh, scale and poses
    lib_rng = np.random.default_rng(0 ^ 0x5EED)
    library = [mr.Mesh(*mr.procedural_car_mesh(lib_rng)) for _ in range(50)]
    dirs = lidar_rays(64, 1500).astype(np.float32)
    worst, off, far = 0.0, 0, 0
    for idx in (0, 1):
        with open(os.path.join(mesh_dir, "meta", f"{idx:08d}.json")) as f:
            meta = json.load(f)
        scene = mr.MeshScene(library[meta["mesh_id"]], seed=meta["seed"],
                             mesh_scale=meta["mesh_scale"])
        for pose in (scene.transform.transform_start,
                     scene.transform.transform_end):
            posed = scene.mesh.posed(scene.mesh_scale, pose)
            got = mr.scan_mesh(posed, scene.mesh.faces, dirs)
            ref = mr._scan_mesh_numpy(posed, scene.mesh.faces, dirs, 120.0)
            off = max(off, abs(len(got) - len(ref)))
            gaps = _scan_gaps(got, ref)
            far = max(far, int((gaps > RAY_ATOL).sum()))
            worst = max(worst, float(gaps.max()))
    print(f"raycast, 2 scenes' 4 scans of {len(dirs)} rays: native vs numpy "
          f"sweep, hit counts differ by at most {off}, at most {far} points "
          f"a scan lie farther than {RAY_ATOL} m from the other side's "
          f"(limit {RAY_COUNT_TOL} each); largest gap {worst:.3e} m")
    check(off <= RAY_COUNT_TOL and far <= RAY_COUNT_TOL,
          "the native raycaster disagrees with its numpy sweep")

    # SynthCars through the CLI against a direct call
    cli_dir, direct_dir = (os.path.join(workdir, d)
                           for d in ("SynthCars_cli", "SynthCars_direct"))
    subprocess.run([sys.executable, "-m", "alignnet3d_tpu_torch.data.generate",
                    "SynthCars", "--out", cli_dir, "--num_train",
                    str(GEN_BOX_TRAIN), "--num_val", str(GEN_BOX_VAL)],
                   cwd=ROOT, check=True, timeout=600)
    generate_dataset(direct_dir, num_train=GEN_BOX_TRAIN,
                     num_val=GEN_BOX_VAL, seed=0, vres=64, hres=1500,
                     allow_persons=False, second_object_set=False)
    files = sorted(os.path.relpath(os.path.join(r, f), direct_dir)
                   for r, _, fs in os.walk(direct_dir) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(direct_dir, cli_dir, files,
                                           shallow=False)
    print(f"SynthCars through the CLI vs generate_dataset: {len(files)} "
          f"files, {len(mismatch) + len(errors)} differ")
    check(not mismatch and not errors and len(files) == 3 * (
        GEN_BOX_TRAIN + GEN_BOX_VAL) + 2,
          "the SynthCars CLI differs from generate_dataset")

    # a flips request over the mesh dataset's val pairs
    pcs1, pcs2 = _val_clouds(mesh_dir)
    reps = -(-PAIRS // len(pcs1))
    pcs1, pcs2 = (list(p) * reps for p in (pcs1, pcs2))
    aligner = Aligner(spec, state, batch_size=PAIRS, seed=SEED,
                      device="cuda")
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = aligner.align(pcs1[:PAIRS], pcs2[:PAIRS], resolve_flips=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    check(all(np.isfinite(v).all() for v in out.values())
          and out["transforms"].shape == (PAIRS, 4, 4),
          "mesh request: non-finite or misshapen answer")
    check(counts["fused_pointnet"] == 3 and counts["nn_argmin"] == 2,
          f"mesh request: launches {counts}, expected 3 and 2")
    print(f"mesh dataset request (flips, {len(_val_clouds(mesh_dir)[0])} val "
          f"pairs tiled to {PAIRS}): {wall * 1e3:.1f} ms, launches {counts}")
    print(f"generation phase: {time.perf_counter() - t_phase:.1f} s")
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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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
    warm_card()
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
        # one forward batch per request, 3 backbones per forward; 2 NN
        # sweeps for the flips, ICP_ITS + 1 for ICP
        expected = {name: 3 * len(kinds) for name in owned}
        if "nn_argmin" in owned:
            expected["nn_argmin"] = sum(
                2 * kw.get("resolve_flips", False)
                + (ICP_ITS + 1) * kw.get("refine_icp", False) for _, kw in kinds)
        for name in owned:
            check(counts[name] == expected[name],
                  f"{name}: {counts[name]} launches, expected {expected[name]}")

    # the exported programs' launches of kernels 1, 3 and 4
    for name, n in export_phase(specs, requests, card).items():
        if name in launches:
            launches[name] += n

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # and the mesh dataset's request (kernels 1 and 2)
        for name, n in generation_phase(workdir, *specs["pointnet"],
                                        card).items():
            if name in launches:
                launches[name] += n
        basepath = os.path.join(workdir, "data")
        t0 = time.perf_counter()
        splits = make_dataset(basepath)
        print(f"dataset: {len(splits['train'])} train + {len(splits['val'])} "
              f"val pairs generated in {time.perf_counter() - t0:.1f} s")
        loader_phase(basepath, card)
        nan_phase(spec, state, requests[0][0] + requests[0][1],
                  *requests[2], basepath, workdir)
        k5 = fused_edge_stage_train_phase(basepath)
        counts = dgcnn_training_phase(basepath, workdir)
        launches["fused_edge_stage_train"] = counts["fused_edge_stage_train"]
        # the data-parallel runs' (kernels 3 and 5, and 2 in process 0's
        # eval) and int8 serving's (kernel 1 on the chains it leaves in
        # float32); then the model options' steps, card against CPU
        for counts in (data_parallel_phase(basepath, workdir, card),
                       int8_phase(spec, state, requests, card)):
            for name in ("fused_pointnet", "nn_argmin", "knn_points",
                         "fused_edge_stage_train"):
                launches[name] += counts[name]
        model_options_phase(basepath, card)
        pointnet_training_phase(basepath, workdir, card)
        # the completion path's (its eval's flips and its request) and the
        # KITTI path's (its request)
        for counts in (completion_phase(basepath, workdir, card),
                       kitti_phase(workdir, card)):
            for name, n in counts.items():
                launches[name] += n
        # nn_argmin's launches: the PointNet serving path's and the
        # refinement path's
        launches["nn_argmin"] += refinement_phase(basepath, workdir)
        # and the two-stage request's, coarse + refiner
        for name, n in trained_runs_phase(basepath, workdir, card).items():
            launches[name] += n
        # and the classical baselines' through the CLI
        n, _ = baseline_phase(basepath, workdir, card)
        launches["nn_argmin"] += n
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
    # functions (a fused chain + max, a masked argmin, a top-k ordered
    # NaN first with index ties, a gathered 2-layer chain + max, the same with
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
