"""KITTI tracking -> registration-dataset generator: the port's copy of
``alignnet3d_tpu/data/kitti_generate.py``, writing the same files.

Produces KITTITrackletsCars-style datasets (meta + pointcloud pairs +
splits) from a KITTI tracking directory:

    python -m alignnet3d_tpu_torch.data.kitti_generate \
        --kitti_root /data/KITTI_tracking --out data/KITTITrackletsCars \
        --classes Car Van

The reference repo consumes these datasets but does not ship the
generation loop (it lived in notebooks); the building blocks it does
ship are reproduced in ``data/kitti.py`` (TrackingLabels filtering/track
splitting, nominal-frame box extraction, relative-transform derivation,
FromKITTIScene writer) — this module is the loop around them:

for each sequence: parse labels -> for each track: pair consecutive
frames -> extract both observations from the velodyne scans (optionally
ego-motion-compensated) -> write the sample. The 'Hard' variants widen
the occlusion/truncation windows (reference dataset family,
README.md:44-47).

Expected KITTI layout (training split):
    <root>/training/velodyne/<seq:04d>/<frame:06d>.bin
    <root>/training/label_02/<seq:04d>.txt
    <root>/preprocessed/training/visual_odometry/vo_<seq:04d>_<frame:06d>.txt
        (optional; identity assumed when missing)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from alignnet3d_tpu_torch.data.kitti import (
    FromKITTIScene,
    TrackingLabels,
    apply_visual_odometry,
    extract_object_points,
    load_velo_scan,
)


def _load_scan(kitti_root: str, seq: int, frame: int, use_vo: bool):
    scan = load_velo_scan(
        f"{kitti_root}/training/velodyne/{seq:04d}/{frame:06d}.bin"
    )
    if use_vo:
        vo_path = (
            f"{kitti_root}/preprocessed/training/visual_odometry/"
            f"vo_{seq:04d}_{frame:06d}.txt"
        )
        if os.path.isfile(vo_path):
            vo = np.loadtxt(vo_path, dtype=np.float32)
            pts = apply_visual_odometry(scan, vo)
            return np.concatenate([pts, scan[:, 3:4]], axis=1)
    return scan


def generate_kitti_dataset(
    kitti_root: str,
    out: str,
    classes=("Car", "Van"),
    sequences=None,
    hard: bool = False,
    min_points: int = 10,
    use_vo: bool = True,
    val_sequences=(2, 6, 7, 8, 10),
):
    """Write the dataset; returns (train_indices, val_indices).

    'hard' widens the filters like the reference's *Hard datasets:
    occlusion window (0,3) and truncation (0,2) stay, but the easy sets
    additionally require occlusion <= 1 and truncation <= 0.5.
    Samples from ``val_sequences`` go to the val split (these sequences'
    tracks are also the eval 'test' subset rule, evaluation.py:159).
    """
    if sequences is None:
        label_dir = f"{kitti_root}/training/label_02"
        sequences = sorted(
            int(f[:-4]) for f in os.listdir(label_dir) if f.endswith(".txt")
        )
    occluded_threshold = 3.0 if hard else 1.0
    truncated_threshold = 2.0 if hard else 0.5

    os.makedirs(os.path.join(out, "split"), exist_ok=True)
    train_idx, val_idx = [], []
    scene_idx = 0
    for seq in sequences:
        label_path = f"{kitti_root}/training/label_02/{seq:04d}.txt"
        if not os.path.isfile(label_path):
            continue
        labels = TrackingLabels(
            label_path,
            occluded_threshold=occluded_threshold,
            truncated_threshold=truncated_threshold,
        )
        rows = [r for r in labels.rows if r["class"] in classes]
        by_track: dict[int, list] = {}
        for r in rows:
            by_track.setdefault(r["id"], []).append(r)

        scan_cache: dict[int, np.ndarray] = {}

        def scan(frame):
            if frame not in scan_cache:
                scan_cache[frame] = _load_scan(kitti_root, seq, frame, use_vo)
                if len(scan_cache) > 4:  # keep the cache tiny
                    scan_cache.pop(next(iter(scan_cache)))
            return scan_cache[frame]

        for tid in sorted(by_track):
            recs = sorted(by_track[tid], key=lambda r: r["frame"])
            for r1, r2 in zip(recs, recs[1:]):
                if r2["frame"] - r1["frame"] != 1:
                    continue
                pc1 = extract_object_points(
                    scan(r1["frame"]), TrackingLabels.boxvec(r1)
                )
                pc2 = extract_object_points(
                    scan(r2["frame"]), TrackingLabels.boxvec(r2)
                )
                if len(pc1) < min_points or len(pc2) < min_points:
                    continue
                scene = FromKITTIScene(r1, r2, pc1, pc2, seq=seq)
                scene.save(out, scene_idx)
                (val_idx if seq in val_sequences else train_idx).append(
                    scene_idx
                )
                scene_idx += 1

    for name, idxs in (("train", train_idx), ("val", val_idx)):
        with open(f"{out}/split/{name}.txt", "w") as f:
            f.write("\n".join(str(i) for i in idxs) + ("\n" if idxs else ""))
    return train_idx, val_idx


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kitti_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--classes", nargs="+", default=["Car", "Van"])
    p.add_argument("--sequences", nargs="*", type=int, default=None)
    p.add_argument("--hard", action="store_true")
    p.add_argument("--no_vo", action="store_true")
    args = p.parse_args(argv)
    train_idx, val_idx = generate_kitti_dataset(
        args.kitti_root, args.out, classes=tuple(args.classes),
        sequences=args.sequences, hard=args.hard, use_vo=not args.no_vo,
    )
    print(f"wrote {len(train_idx)} train / {len(val_idx)} val samples")


if __name__ == "__main__":
    main()
