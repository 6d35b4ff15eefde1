"""Standalone ICP evaluation (``evaluation.special.mode == 'icp'``), the
classical baselines: counterpart of ``alignnet3d_tpu/icp/runner.py``
(reference icp.py:150-213).

Variants (reference make_icp_configs.py:6-26):
- ``p2point``: centroid-difference init + constrained point-to-point ICP,
  radius 0.10 (reference icp.py:184-185, 69-78);
- ``o3_gicp``: FPFH features + parallel-hypothesis RANSAC (reference
  icp.py:85-105; ``icp/fpfh.py``);
- ``o3_gicp_fast``: FPFH features + Fast Global Registration (reference
  icp.py:121-143; ``icp/fgr.py``);
- ``multistart``: a parallel yaw multi-start of coarse-to-fine constrained
  ICP (``icp/p2point.py:multistart_global_registration``);
- with ``refine`` set, the ``o3_gicp*`` variants refine the stored outputs
  of their base run (the config's log directory without its ``_p2p``) by
  point-to-point ICP and add the base run's mean time to their own
  (reference icp.py:160-170).

Every chunk of ``pair_chunk`` pairs runs on ``device``, timed on the host
clock up to the numpy readback of its answers. Pair i's random draws
depend only on its position in the val set. Artifacts match the
reference: pred_translations / pred_angles / pred_s1_pc1centers npys +
eval.json / eval_180.json; the answers are world-frame, so the rotation
centres are zero (icp.py:196-198).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from alignnet3d_tpu_torch.data import provider
from alignnet3d_tpu_torch.evaluation import metrics as evaluation
from alignnet3d_tpu_torch.geometry import get_mat_angle
from alignnet3d_tpu_torch.icp.fpfh import global_registration_batch
from alignnet3d_tpu_torch.icp.p2point import (
    icp_p2point_batch,
    multistart_global_registration,
    pad_full_clouds,
)

logger = logging.getLogger("alignnet3d_tpu_torch")

SEED = 0  # of the RANSAC and FGR draws


def evaluate(cfg, use_old_results: bool = False, pair_chunk: int = 128,
             max_points: int = 4096, *, device: torch.device | str):
    """Run the configured baseline over the val set on ``device`` and write
    its artifacts; returns the eval dict (accept_inverted_angle on)."""
    val_idxs = provider.getDataFiles(f"{cfg.data.basepath}/split/val.txt")
    dataset = provider.PackedDataset(cfg.data.basepath)

    epoch = 0
    total_time = 0.0
    icp_cfg = cfg.evaluation.special.icp
    variant = icp_cfg.variant
    with_constraint = icp_cfg.with_constraint
    do_refinement = icp_cfg.has("refine")

    precomp = None
    if variant in ("o3_gicp", "o3_gicp_fast") and do_refinement:
        gicp_result_dir = (
            f"{cfg.logging.logdir[:-4]}/val/eval{str(epoch).zfill(6)}")
        assert os.path.isdir(gicp_result_dir), gicp_result_dir
        eval_json = f"{gicp_result_dir}/eval_180.json"
        assert os.path.isfile(eval_json), eval_json
        with open(eval_json) as f:
            total_time += json.load(f)["mean_time"] * float(len(val_idxs))
        precomp = tuple(np.load(f"{gicp_result_dir}/pred_{k}.npy") for k in
                        ("translations", "angles", "s1_pc1centers"))
        logger.info("Precomputed results loaded")

    rows = dataset.rows(val_idxs)
    # one padded length for the whole set
    global_pad = max(1, min(max_points, int(max(
        dataset.counts1[rows].max(initial=1),
        dataset.counts2[rows].max(initial=1)))))

    eval_dir = f"{cfg.logging.logdir}/val/eval{str(epoch).zfill(6)}"
    n = len(val_idxs)
    if use_old_results and os.path.isfile(f"{eval_dir}/pred_translations.npy"):
        all_pred_translations = np.load(f"{eval_dir}/pred_translations.npy")
        all_pred_angles = np.load(f"{eval_dir}/pred_angles.npy")
        all_pred_centers = np.load(f"{eval_dir}/pred_s1_pc1centers.npy")
    else:
        all_pred_translations = np.empty((n, 3), np.float32)
        all_pred_angles = np.empty((n, 1), np.float32)
        all_pred_centers = np.zeros((n, 3), np.float32)

        for s in range(0, n, pair_chunk):
            e = min(s + pair_chunk, n)
            (src, sm), (dst, dm) = pad_full_clouds(
                dataset, val_idxs[s:e], max_points=max_points,
                pad_to=global_pad)
            t0 = time.time()
            if variant == "p2point" or precomp is not None:
                if precomp is not None:
                    init = np.stack([get_mat_angle(*(p[i] for p in precomp))
                                     for i in range(s, e)])
                else:
                    # centroid-difference init (icp.py:62-66, 74)
                    c1 = (src * sm[..., None]).sum(1) / np.maximum(
                        sm.sum(1)[:, None], 1)
                    c2 = (dst * dm[..., None]).sum(1) / np.maximum(
                        dm.sum(1)[:, None], 1)
                    init = np.tile(np.eye(4), (e - s, 1, 1))
                    init[:, :3, 3] = c2 - c1
                tf, _, _ = icp_p2point_batch(
                    src, sm, dst, dm, init, radius=0.10, its=30,
                    with_constraint=with_constraint, device=device)
            elif variant in ("o3_gicp", "o3_gicp_fast"):
                extra = {}
                if variant == "o3_gicp":
                    # framework tuning knobs: RANSAC hypothesis count and
                    # reciprocal-match pruning
                    if icp_cfg.has("num_hypotheses"):
                        extra["num_hypotheses"] = int(icp_cfg.num_hypotheses)
                    if icp_cfg.has("mutual_filter"):
                        extra["mutual_filter"] = bool(icp_cfg.mutual_filter)
                tf, _, _ = global_registration_batch(
                    src, sm, dst, dm, voxel_size=icp_cfg.get("voxel_size",
                                                             0.05),
                    seed=SEED, pair_ids=range(s, e),
                    method="ransac" if variant == "o3_gicp" else "fgr",
                    with_constraint=with_constraint, device=device, **extra)
            elif variant == "multistart":
                tf, _, _ = multistart_global_registration(
                    src, sm, dst, dm, num_yaw_hypotheses=8, device=device)
            else:
                raise AssertionError(f"unimplemented ICP variant {variant!r}")
            total_time += time.time() - t0
            all_pred_translations[s:e] = tf[:, :3, 3]
            all_pred_angles[s:e, 0] = np.arctan2(tf[:, 1, 0], tf[:, 0, 0])

        os.makedirs(eval_dir, exist_ok=True)
        np.save(f"{eval_dir}/pred_translations.npy", all_pred_translations)
        np.save(f"{eval_dir}/pred_angles.npy", all_pred_angles)
        np.save(f"{eval_dir}/pred_s1_pc1centers.npy", all_pred_centers)

    metas = dataset.metas(val_idxs)
    for accept_inverted_angle in (False, True):
        eval_dict = evaluation.evaluate(
            cfg, val_idxs, all_pred_translations, all_pred_angles,
            dataset.translations[rows], dataset.rel_angles[rows],
            all_pred_centers, dataset.pc1centers[rows], eval_dir=eval_dir,
            accept_inverted_angle=accept_inverted_angle,
            mean_time=total_time / max(1, n), metas=metas)
        logger.info(evaluation.ns_to_dict(eval_dict))
    return eval_dict
