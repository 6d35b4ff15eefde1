"""Shared success-level scorer for the tuning/probe scripts.

Counterpart of ``alignnet3d_tpu/evaluation/quickscore.py``, over the
port's ``geometry.py``. One implementation of the rebase-and-threshold table that
``scripts/tune_ransac.py``, ``scripts/tune_refine_cascade.py`` and
``scripts/probe_tta.py`` print: predictions are re-based to the GT
rotation center exactly like the metric pipeline (reference
evaluation.py:129), then scored at the three reference success levels
(<2cm & <1deg, <10cm & <5deg, <20cm & <10deg — reference
evaluation.py:16-46) on the val (position < 1000) and test
(position >= 1000) subsets of the val split (reference
evaluation.py:158-161; the POSITIONAL rule, matching
``metrics._is_test``, not the on-disk file index).
"""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.geometry import (
    angle_diff,
    translate_transform_to_new_center_of_rotation,
)

LEVELS = ((0.02, 1.0), (0.10, 5.0), (0.20, 10.0))


def positional_is_test(n: int) -> np.ndarray:
    """Synth val/test membership by POSITION in the val split (metrics.py
    ``_is_test``): positions >= 1000 are the held-out test subset."""
    return np.arange(n) >= 1000


def success_table(pred_t, pred_a, pred_c, gt_t, gt_a, gt_c,
                  is_test=None, accept_inverted: bool = True) -> dict:
    """Success-level fractions per subset.

    Returns ``{"all": [l1, l2, l3], "val": [...], "test": [...]}`` where
    each entry is the fraction of pairs whose re-based XY translation
    error and yaw error both beat the corresponding level. Subsets with
    no members score NaN.
    """
    pred_t = np.asarray(pred_t, np.float64).reshape(-1, 3)
    pred_a = np.asarray(pred_a, np.float64).reshape(-1)
    pred_c = np.asarray(pred_c, np.float64).reshape(-1, 3)
    gt_t = np.asarray(gt_t, np.float64).reshape(-1, 3)
    gt_a = np.asarray(gt_a, np.float64).reshape(-1)
    gt_c = np.asarray(gt_c, np.float64).reshape(-1, 3)
    n = len(pred_t)
    if is_test is None:
        is_test = positional_is_test(n)
    is_test = np.asarray(is_test, bool)

    rb = translate_transform_to_new_center_of_rotation(pred_t, pred_a, pred_c, gt_c)
    terr = np.linalg.norm(rb[:, :2] - gt_t[:, :2], axis=1)
    aerr = np.abs(np.degrees(angle_diff(pred_a, gt_a)))
    if accept_inverted:
        aerr = np.minimum(aerr, np.abs(aerr - 180.0))

    out = {}
    for tag, mask in (("all", np.ones(n, bool)), ("val", ~is_test),
                      ("test", is_test)):
        if mask.any():
            out[tag] = [float(np.mean((terr[mask] < lt) & (aerr[mask] < la)))
                        for lt, la in LEVELS]
        else:
            out[tag] = [float("nan")] * len(LEVELS)
    return out


def format_table(table: dict, subsets=("val", "test")) -> str:
    """One-line rendering: ``val 4.8/52.4/80.8  test 3.9/47.0/78.6``."""
    return "  ".join(
        f"{tag} " + "/".join(f"{100 * x:.1f}" for x in table[tag])
        for tag in subsets
    )
