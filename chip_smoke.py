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
7. prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

Any failed phase exits non-zero without the last line. So does a machine
without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "SynthCars.json"
DGCNN_CONFIG = ROOT / "configs" / "SynthCars40kDGCNN.json"
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
    from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
    from alignnet3d_tpu_torch.ops import knn_kernels as kk
    from alignnet3d_tpu_torch.ops import nn_kernels as nk
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

    wrappers = {"fused_pointnet": pk.fused_pointnet, "nn_argmin": nk.nn_argmin,
                "knn_points": kk.knn_points,
                "fused_edge_stage": ek.fused_edge_stage}
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
    )
    # library_ms is null: no one PyTorch call computes any of these
    # functions (a fused chain + max, a masked argmin, an ordered top-k
    # with index ties, a gathered 2-layer chain + max)
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
