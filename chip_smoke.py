#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90).

    python3 chip_smoke.py

From the root of a checkout, with nothing built beforehand:

1. checks for a Hopper card and prints its name and power limit;
2. builds the CUDA kernels from ``alignnet3d_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch twin at the shapes the
   serving path gives it, timing both with CUDA events;
4. serves 3 requests of 128 synthetic LiDAR pairs through
   ``Aligner.align`` at the full width of ``configs/SynthCars.json``
   (seeded random weights), counting every kernel launch;
5. sends the same requests through the port on the CPU, where it runs the
   twins, and compares the answers;
6. prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

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
SEED = 0
PAIRS = 128       # pairs per request, one serving batch
REQUESTS = (      # (name, align kwargs)
    ("plain", {}),
    ("flips", {"resolve_flips": True}),
    ("flips+icp", {"resolve_flips": True, "refine_icp": True}),
)
NET_ATOL = 1e-3          # network-only answers, card vs CPU
TIE_MARGIN = 1e-3        # a decision this close is settled by rounding
ICP_TOL = (0.01, 0.1)    # m, degrees
ICP_AGREE = 0.95         # share of ICP pairs within ICP_TOL
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def _scene_clouds(seed: int):
    from alignnet3d_tpu_torch.host import SyntheticBoxScene

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
            result[(name, dtype)] = (err, ms, plain_ms)
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
    cases = {
        "flip": (flip[0], flip[1], np.ones(flip[1].shape[:2], bool)),
        "icp": (a1, a2, m2),
    }
    result = {}
    for name, (src, dst, mask) in cases.items():
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
        result[name] = (err, ms, plain_ms)
    return result


def serve(aligner, requests, sync):
    outs, walls, states = [], [], []
    for (name, kwargs), (pcs1, pcs2) in zip(REQUESTS, requests):
        states.append(aligner._rng.bit_generator.state)
        t0 = time.perf_counter()
        outs.append(aligner.align(pcs1, pcs2, **kwargs))
        sync()
        walls.append(time.perf_counter() - t0)
    return outs, walls, states


def _top2_gap(logits, nb):
    top = np.sort(logits[:, :nb], axis=1)[:, -2:]
    return (top[:, 1] - top[:, 0]) / (1.0 + np.abs(top[:, 1]))


def rounding_decided(spec, state, rng_state, pcs1, pcs2, flips: bool):
    """Pairs whose answer hangs on a near-tie, judged on the CPU run: an
    argmax of yaw logits within TIE_MARGIN, or (with flips) chamfer scores
    of the two yaw hypotheses within TIE_MARGIN of each other."""
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
    return flagged


def _angle_gap(a, b):
    return np.abs(np.mod(a - b + np.pi, 2 * np.pi) - np.pi)


def cross_check(spec, state, requests, gpu_outs, states):
    from alignnet3d_tpu_torch.api import Aligner

    cpu = Aligner(spec, state, batch_size=PAIRS, seed=SEED, device="cpu")
    t0 = time.perf_counter()
    cpu_outs, _, _ = serve(cpu, requests, lambda: None)
    print(f"CPU run of the same requests: {time.perf_counter() - t0:.1f} s")
    for r, ((name, kwargs), g, c) in enumerate(zip(REQUESTS, gpu_outs, cpu_outs)):
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
        ties = rounding_decided(spec, state, states[r], pcs1, pcs2,
                                kwargs.get("resolve_flips", False))
        gap = np.maximum(np.maximum(dt, dc), da)
        ok = gap <= NET_ATOL
        print(f"request {name}: card vs CPU, max gap {gap[~ties].max():.3e} "
              f"over {int((~ties).sum())} pairs (atol {NET_ATOL}); "
              f"{int(ties.sum())} pairs at a near-tie, of which "
              f"{int((~ok & ties).sum())} differ")
        check(ok[~ties].all(), f"request {name}: card and CPU answers differ")
        check(ties.mean() <= 0.05, f"request {name}: too many near-ties")


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

    from alignnet3d_tpu_torch.api import Aligner
    from alignnet3d_tpu_torch.host import config_from_dict
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec
    from alignnet3d_tpu_torch.ops import _build
    from alignnet3d_tpu_torch.ops import nn_kernels as nk
    from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

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

    with open(CONFIG) as f:
        spec = ModelSpec.from_config(config_from_dict(json.load(f)))
    state = seeded_weights(spec)
    print(f"model: {CONFIG.name}, N={spec.num_points}, bins={spec.num_bins}, "
          f"s1 {spec.s1_backbone}, s2 {spec.s2_backbone}, "
          f"embedding {spec.embedding}, heads {spec.s1_mlp}, "
          f"{spec.compute_dtype}")

    k1 = fused_pointnet_phase(spec, state, requests[0][0] + requests[0][1])
    k2 = nn_argmin_phase(spec, *requests[2])

    # warm-up of every path (cuBLAS handles, allocator) on a throwaway
    # server, so that the request times below are steady-state times
    Aligner(spec, state, batch_size=PAIRS, seed=SEED + 1,
            device="cuda").align(*requests[2], **REQUESTS[2][1])
    torch.cuda.synchronize()

    aligner = Aligner(spec, state, batch_size=PAIRS, seed=SEED, device="cuda")
    pk.fused_pointnet.launches = 0
    nk.nn_argmin.launches = 0
    gpu_outs, walls, states = serve(aligner, requests, torch.cuda.synchronize)
    launches = {"fused_pointnet": pk.fused_pointnet.launches,
                "nn_argmin": nk.nn_argmin.launches}
    for (name, _), wall, out in zip(REQUESTS, walls, gpu_outs):
        check(all(np.isfinite(v).all() for v in out.values()),
              f"request {name}: non-finite answer")
        check(out["transforms"].shape == (PAIRS, 4, 4),
              f"request {name}: wrong shape")
        print(f"request {name}: {PAIRS} pairs in {wall * 1e3:.1f} ms "
              f"(host clock, ends in a synchronize)")
    print(f"kernel launches while serving: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the serving path")

    cross_check(spec, state, requests, gpu_outs, states)

    emb = k1[("embedding", torch.float32)]
    kernels = [
        {"name": "fused_pointnet", "route": "cuda",
         "source": "alignnet3d_tpu_torch/csrc/fused_pointnet.cu",
         "replaces": "alignnet3d_tpu/ops/pointnet_kernels.py:74",
         "launches": launches["fused_pointnet"], "max_abs_err": emb[0],
         "ms": emb[1], "plain_ms": emb[2]},
        {"name": "nn_argmin", "route": "cuda",
         "source": "alignnet3d_tpu_torch/csrc/nn_argmin.cu",
         "replaces": "alignnet3d_tpu/ops/nn_kernels.py:80",
         "launches": launches["nn_argmin"], "max_abs_err": k2["icp"][0],
         "ms": k2["icp"][1], "plain_ms": k2["icp"][2]},
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
