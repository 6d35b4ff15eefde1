"""Evaluation metrics and the eval.json / eval_180.json artifacts.

The port's own copy of ``alignnet3d_tpu/evaluation/metrics.py`` (reference
evaluation.py:16-289), with the same arithmetic: level accuracies
(translation < {2, 10, 20} cm in XY; yaw < {1, 5, 10} degrees, optionally
accepting the 180-degree flip), distance buckets, val/test subsets, the
JSON files with a timestamped backup, and per-track velocities.

val/test membership: KITTI-tracklet metas are 'test' when
``trackids[0]`` is one of {2, 6, 7, 8, 10}; Synth datasets are 'test' for
idx >= 1000. ``evaluate_held`` is the velocity-only eval of Held-style
tracking data (evaluation.special.mode 'held').
"""

from __future__ import annotations

import datetime
import json
import os
from argparse import Namespace
from collections import defaultdict
from shutil import copyfile

import numpy as np

from alignnet3d_tpu_torch.geometry import (
    translate_transform_to_new_center_of_rotation,
    wrap_angle,
)

TRANSLATION_LEVELS = np.array([0.02, 0.1, 0.2])
ANGLE_LEVELS_DEG = np.array([1.0, 5.0, 10.0])
DIST_BUCKETS = {"all": np.inf, "5m": 5.0, "10m": 10.0, "15m": 15.0, "20m": 20.0}


def ns_to_dict(ns):
    return {
        k: ns_to_dict(v) if isinstance(v, Namespace) else v
        for k, v in ns.__dict__.items()
    }


# ---------------------------------------------------------------- scalar core


def eval_translation(t, gt_t):
    """XY translation error + level indicators (evaluation.py:16-23)."""
    dist = float(np.linalg.norm(np.asarray(t)[:2] - np.asarray(gt_t)[:2]))
    levels = (dist < TRANSLATION_LEVELS).astype(int)
    return dist, levels


def eval_angle(a, gt_a, accept_inverted_angle):
    """Yaw error in degrees + level indicators (evaluation.py:31-40)."""
    dist = abs(float(wrap_angle(gt_a - a))) / np.pi * 180.0
    if accept_inverted_angle:
        dist = min(dist, abs(float(wrap_angle(gt_a - (a + np.pi)))) / np.pi * 180.0)
    levels = (dist < ANGLE_LEVELS_DEG).astype(int)
    return dist, levels


def eval_transform(t, gt_t, a, gt_a, accept_inverted_angle):
    _, lt = eval_translation(t, gt_t)
    _, la = eval_angle(a, gt_a, accept_inverted_angle=accept_inverted_angle)
    return np.minimum(lt, la)


# ------------------------------------------------------------ vectorized core


def _vector_errors(pred_t, gt_t, pred_a, gt_a, accept_inverted_angle):
    """Per-sample (dist_transl, levels_transl, dist_angle_deg, levels_angle,
    combined levels), all vectorized."""
    pred_t = np.asarray(pred_t, dtype=np.float64).reshape(-1, 3)
    gt_t = np.asarray(gt_t, dtype=np.float64).reshape(-1, 3)
    pred_a = np.asarray(pred_a, dtype=np.float64).reshape(-1)
    gt_a = np.asarray(gt_a, dtype=np.float64).reshape(-1)

    dist_transl = np.linalg.norm(pred_t[:, :2] - gt_t[:, :2], axis=1)
    levels_transl = (dist_transl[:, None] < TRANSLATION_LEVELS[None, :]).astype(
        np.float64
    )

    dist_angle = np.abs(wrap_angle(gt_a - pred_a)) / np.pi * 180.0
    if accept_inverted_angle:
        dist_angle = np.minimum(
            dist_angle, np.abs(wrap_angle(gt_a - (pred_a + np.pi))) / np.pi * 180.0
        )
    levels_angle = (dist_angle[:, None] < ANGLE_LEVELS_DEG[None, :]).astype(
        np.float64
    )
    levels = np.minimum(levels_transl, levels_angle)
    return dist_transl, levels_transl, dist_angle, levels_angle, levels


def _empty_measures():
    return {
        "corr_levels_translation": np.zeros(3),
        "corr_levels_angles": np.zeros(3),
        "corr_levels": np.zeros(3),
        "mean_dist_translation": 0.0,
        "mean_sq_dist_translation": 0.0,
        "mean_dist_angle": 0.0,
        "mean_sq_dist_angle": 0.0,
        "num": 0,
    }


def _accumulate(measures, mask, dt, lt, da, la, lv):
    n = int(mask.sum())
    measures["num"] += n
    if n == 0:
        return
    measures["corr_levels_translation"] += lt[mask].sum(axis=0)
    measures["mean_dist_translation"] += dt[mask].sum()
    measures["mean_sq_dist_translation"] += (dt[mask] ** 2).sum()
    measures["corr_levels_angles"] += la[mask].sum(axis=0)
    measures["mean_dist_angle"] += da[mask].sum()
    measures["mean_sq_dist_angle"] += (da[mask] ** 2).sum()
    measures["corr_levels"] += lv[mask].sum(axis=0)


def _finalize(measures):
    num = float(measures["num"])
    if measures["num"] == 0:
        num = 1e-20  # reference sentinel: blows numbers up to flag invalid eval
    measures["corr_levels_translation"] = measures["corr_levels_translation"] / num
    measures["mean_dist_translation"] = measures["mean_dist_translation"] / num
    measures["mean_sq_dist_translation"] = float(
        np.sqrt(measures["mean_sq_dist_translation"] / num)
    )
    measures["corr_levels_angles"] = measures["corr_levels_angles"] / num
    measures["mean_dist_angle"] = measures["mean_dist_angle"] / num
    measures["mean_sq_dist_angle"] = float(
        np.sqrt(measures["mean_sq_dist_angle"] / num)
    )
    measures["corr_levels"] = measures["corr_levels"] / num


def _measures_ns(m):
    return Namespace(
        corr_levels=np.asarray(m["corr_levels"]).tolist(),
        corr_levels_translation=np.asarray(m["corr_levels_translation"]).tolist(),
        mean_dist_translation=float(m["mean_dist_translation"]),
        mean_sq_dist_translation=float(m["mean_sq_dist_translation"]),
        corr_levels_angles=np.asarray(m["corr_levels_angles"]).tolist(),
        mean_dist_angle=float(m["mean_dist_angle"]),
        mean_sq_dist_angle=float(m["mean_sq_dist_angle"]),
        num=int(m["num"]),
    )


def _node_ns(node):
    ns = _measures_ns(node["all"])
    for key in ["5m", "10m", "15m", "20m"]:
        ns.__dict__[f"eval_{key}"] = _measures_ns(node[key])
    return ns


def _load_meta(cfg, val_idx):
    with open(f"{cfg.data.basepath}/meta/{str(val_idx).zfill(8)}.json") as f:
        return json.load(f)


def _is_test(meta, basepath, idx):
    if meta is not None and "trackids" in meta:
        return meta["trackids"][0] in [2, 6, 7, 8, 10]
    if "Synth" in basepath:
        return idx >= 1000
    return False


# ------------------------------------------------------------------ top level


def evaluate(
    cfg,
    val_idxs,
    all_pred_translations,
    all_pred_angles,
    all_gt_translations,
    all_gt_angles,
    all_pred_centers,
    all_gt_pc1centers,
    eval_dir=None,
    accept_inverted_angle=False,
    detailed_eval=False,
    avg_window=5,
    mean_time=0,
    metas=None,
):
    """Full evaluation pass (reference evaluation.py:128-289).

    ``metas``: optional pre-loaded list of meta dicts (one per val idx) to
    skip per-sample file IO; when None they are read from
    ``cfg.data.basepath/meta``.
    """
    n = len(val_idxs)
    new_pred_t = translate_transform_to_new_center_of_rotation(
        all_pred_translations, all_pred_angles, all_pred_centers, all_gt_pc1centers
    )
    dt, lt, da, la, lv = _vector_errors(
        new_pred_t, all_gt_translations, all_pred_angles, all_gt_angles,
        accept_inverted_angle,
    )

    if metas is None:
        metas = [_load_meta(cfg, v) for v in val_idxs]
    basepath = cfg.data.basepath
    is_test = np.array(
        [_is_test(m, basepath, i) for i, m in enumerate(metas)], dtype=bool
    )

    centroid_dist = np.linalg.norm(
        np.asarray(all_gt_pc1centers, dtype=np.float64).reshape(-1, 3), axis=1
    )
    valid = dt <= 10000  # outlier guard, evaluation.py:166

    eval_measures = {}
    for set_name in ["both", "val", "test"]:
        if set_name == "both":
            set_mask = valid
        elif set_name == "val":
            set_mask = valid & ~is_test
        else:
            set_mask = valid & is_test
        node = {}
        for key, limit in DIST_BUCKETS.items():
            m = _empty_measures()
            mask = set_mask & (centroid_dist <= limit)
            _accumulate(m, mask, dt, lt, da, la, lv)
            _finalize(m)
            node[key] = m
        eval_measures[set_name] = node

    # per-track velocity export (evaluation.py:214-227)
    tracks = defaultdict(dict)
    for idx, (file_idx, meta) in enumerate(zip(val_idxs, metas)):
        if meta is not None and "seq" in meta:
            seq = int(meta["seq"])
            trackid = int(meta["trackids"][0])
            frame2 = int(meta["frames"][1])
            intermediate_trackid = seq * 10000000 + trackid * 10000
            tracks[intermediate_trackid][frame2] = (
                np.asarray(all_pred_translations[idx], dtype=np.float64),
                0.1,
            )
    if len(tracks) > 0:
        process_velocities(tracks, eval_dir, avg_window)

    eval_dict = _node_ns(eval_measures["both"])
    eval_dict.__dict__["val"] = _node_ns(eval_measures["val"])
    eval_dict.__dict__["test"] = _node_ns(eval_measures["test"])
    # fitness / inlier_rmse hardwired to 0 like the reference
    # (evaluation.py:213, 271)
    eval_dict.__dict__["reg_eval"] = Namespace(fitness=0.0, inlier_rmse=0.0)
    eval_dict.__dict__["mean_time"] = mean_time

    if eval_dir is not None:
        os.makedirs(eval_dir, exist_ok=True)
        filename = f'{eval_dir}/eval{"_180" if accept_inverted_angle else ""}.json'
        if os.path.isfile(filename):
            datestr = datetime.datetime.today().strftime("%Y-%m-%d_%H-%M-%S")
            copyfile(filename, f"{filename[:-5]}_{datestr}.json")
            if mean_time == 0:
                with open(filename) as f:
                    prev = json.load(f)
                if "mean_time" in prev:
                    eval_dict.__dict__["mean_time"] = prev["mean_time"]
        with open(filename, "w") as f:
            json.dump(ns_to_dict(eval_dict), f)

    if detailed_eval:
        per_transform_info = [
            [lv[i], float(dt[i]), float(da[i])] for i in range(n)
        ]
        return eval_dict, per_transform_info
    return eval_dict


def process_velocities(tracks, eval_dir, avg_window):
    """Sliding-window track velocities written per track
    (reference evaluation.py:81-112)."""
    if eval_dir is None:
        return None
    out_dir = eval_dir + "/velocities"
    os.makedirs(out_dir, exist_ok=True)
    velocities = defaultdict(list)
    for intermediate_trackid, traj in tracks.items():
        max_frame = max(traj.keys())
        start_frames = [
            idx
            for idx in range(max_frame + 1)
            if idx in traj and idx - 1 not in traj
        ]
        for start_frame in start_frames:
            new_track_id = intermediate_trackid + start_frame - 1
            track_translations = [(np.array([0.0, 0, 0]), 0.1)]
            for curr_frame in range(start_frame, max_frame + 1):
                track_translations.append(traj[curr_frame])
                if curr_frame + 1 not in traj:
                    break
            track_translations = np.array(track_translations, dtype=object)
            with open(f"{out_dir}/track{new_track_id:09}.txt", "w") as fh:
                for idx in range(len(track_translations)):
                    window = track_translations[
                        max(0, idx - avg_window) : idx + avg_window + 1
                    ]
                    vels = np.stack(
                        [np.asarray(t) / dt for t, dt in window]
                    )
                    mean_velocity = np.mean(vels, axis=0)
                    mean_velocity_length = float(
                        np.linalg.norm(mean_velocity[:2])
                    )
                    velocities[new_track_id].append(mean_velocity_length)
                    fh.write(f"{mean_velocity_length}\n")
    return velocities


def evaluate_held(cfg, val_idxs, all_pred_translations, all_pred_angles,
                  all_gt_translations, all_gt_angles, eval_dir=None,
                  avg_window=5, mean_time=0, metas=None):
    """Velocity-only eval of Held-style tracking data (reference
    evaluation.py:49-78): per track, the XY speed of the predicted
    translations over the time between the pair's frames (at least
    0.05 s), averaged over a window of ``avg_window`` frames before and
    after, one value a line in ``eval_dir/track<id>.txt``. Returns
    (velocities by track id, {"mean_time": mean_time})."""
    if metas is None:
        metas = [_load_meta(cfg, v) for v in val_idxs]
    tracks = defaultdict(dict)
    for idx, meta in enumerate(metas):
        trackid = meta["trackid"]
        frame2 = meta["frames"][1]
        timestamp1, timestamp2 = meta["timestamps"]
        time_passed = max(0.05, timestamp2 - timestamp1)
        tracks[trackid][frame2] = (
            np.asarray(all_pred_translations[idx], dtype=np.float64),
            time_passed)

    velocities = defaultdict(list)
    for trackid, track in tracks.items():
        track_translations = list(track.values())
        if eval_dir is None:
            continue
        os.makedirs(eval_dir, exist_ok=True)
        with open(f"{eval_dir}/track{trackid}.txt", "w") as fh:
            for idx in range(len(track_translations)):
                window = track_translations[
                    max(0, idx - avg_window + 1):idx + avg_window + 1]
                vels = np.stack([np.asarray(t) / dt for t, dt in window])
                mean_velocity = np.mean(vels, axis=0)
                mean_velocity_length = float(np.linalg.norm(mean_velocity[:2]))
                velocities[trackid].append(mean_velocity_length)
                fh.write(f"{mean_velocity_length}\n")
    return velocities, dict(mean_time=mean_time)
