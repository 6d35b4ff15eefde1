"""Held-style tracking dataset writer, the port's copy of
``alignnet3d_tpu/data/held.py`` (reference FromHeldScene,
tp_utils/pointcloud.py:1036-1052): pairs of consecutive observations of a
tracked object with timestamps; pose labels are all-zero (the velocity-only
``evaluate_held`` path consumes predicted translations + timestamps)."""

from __future__ import annotations

import json
import os

import numpy as np

from alignnet3d_tpu_torch.geometry import np_to_str


class FromHeldScene:
    def __init__(self, trackid, frame1: int, frame2: int,
                 tracklet1, tracklet2, obj_class: str = "Car"):
        pc1, timestamp1 = tracklet1
        pc2, timestamp2 = tracklet2
        self.pointclouds = [np.asarray(pc1, np.float32),
                            np.asarray(pc2, np.float32)]
        zero = np.zeros(3)
        self.meta = {
            "start_position": np_to_str(zero),
            "start_angle": 0.0,
            "end_position": np_to_str(zero),
            "end_angle": 0.0,
            "translation": np_to_str(zero),
            "rel_angle": 0.0,
            "class": obj_class,
            "frames": [int(frame1), int(frame2)],
            "timestamps": [float(timestamp1), float(timestamp2)],
            "trackid": trackid,
        }

    def save(self, basepath: str, scene_idx: int):
        for sub in ("meta", "pointcloud1", "pointcloud2"):
            os.makedirs(os.path.join(basepath, sub), exist_ok=True)
        for k, pc in enumerate(self.pointclouds):
            np.save(
                f"{basepath}/pointcloud{k + 1}/{str(scene_idx).zfill(8)}", pc
            )
        with open(f"{basepath}/meta/{str(scene_idx).zfill(8)}.json", "w") as f:
            json.dump(self.meta, f)
