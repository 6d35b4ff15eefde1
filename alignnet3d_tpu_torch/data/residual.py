"""The residual-alignment training task (``data.residual_task``): pc1 is
pre-aligned by the ground truth composed with a small sampled residual, so
a model fine-tuned on it learns the near-identity transforms a refinement
pass sees. The port's copy of ``alignnet3d_tpu/data/residual.py``: the
same numpy RNG calls in the same order and the same float64 arithmetic, so
a seed gives the same batches in both packages.

Serving uses such a model as the second stage of ``network_refine``: the
coarse model runs first, its transform moves pc1, and the refiner predicts
the remaining correction (``api.Aligner.align(network_refine=True,
refine_variables=...)``, ``evaluation.network_refine.weights``).

Label rewrite: for a sampled residual dT (yaw ``da`` about the target
object centre c2, then translation ``dt``), pc1 is moved by
M = dT^-1 @ T_gt, so the new true relative transform is exactly dT. The
labels move with it: pc1's centre and angle by M, the translation re-based
to the moved centre c1' = M c1 (rotation about the frame-1 object centre,
reference pointcloud.py:888-906).

Sampling: a gaussian core (angle_std_deg, xy_std, z_std), an outlier tail
(outlier_prob, outlier_angle_deg, outlier_xy) and a flip tail (flip_prob:
da += pi). Config: ``data.residual_task`` with ``enabled`` and any of
those keys (defaults below). ``Trainer._make_batch`` applies it to train
and eval batches alike.
"""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.geometry import (
    get_mat_angle_batch,
    invert_rigid_batch,
    rotation_matrix_z,
)

DEFAULTS = dict(
    angle_std_deg=1.5,
    xy_std=0.08,
    z_std=0.02,
    outlier_prob=0.15,
    outlier_angle_deg=10.0,
    outlier_xy=0.4,
    flip_prob=0.1,
)


def params_from_config(cfg) -> dict | None:
    """The task's parameters from a config, or None when it is off."""
    if not (cfg.data.has("residual_task")
            and cfg.data.residual_task.enabled):
        return None
    rt = cfg.data.residual_task
    return {k: (getattr(rt, k) if rt.has(k) else v)
            for k, v in DEFAULTS.items()}


def apply_residual_task(batch, rng: np.random.Generator, *,
                        angle_std_deg: float, xy_std: float, z_std: float,
                        outlier_prob: float, outlier_angle_deg: float,
                        outlier_xy: float, flip_prob: float):
    """Rewrite a ``PackedDataset.sample_batch`` 8-tuple (pc1, pc2,
    translation, rel_angle, pc1center, pc2center, pc1angle, pc2angle) into
    the residual task. Returns a tuple of the same shapes; pc2 and its
    labels are the same objects. An empty (all-zero) pc1 stays zero."""
    pc1, pc2, t, a, c1, c2, a1, a2 = batch
    b = len(pc1)
    t = np.asarray(t, np.float64).reshape(b, 3)
    a = np.asarray(a, np.float64).reshape(b)
    c1 = np.asarray(c1, np.float64).reshape(b, 3)
    c2 = np.asarray(c2, np.float64).reshape(b, 3)

    # the residual: gaussian core, outlier tail, flip tail
    da = rng.normal(0.0, np.radians(angle_std_deg), b)
    dt = rng.normal(0.0, 1.0, (b, 3)) * np.array([xy_std, xy_std, z_std])
    is_out = rng.random(b) < outlier_prob
    da_out = rng.normal(0.0, np.radians(outlier_angle_deg), b)
    dt_out = rng.normal(0.0, 1.0, (b, 3)) * np.array(
        [outlier_xy, outlier_xy, z_std])
    da = np.where(is_out, da_out, da)
    dt = np.where(is_out[:, None], dt_out, dt)
    da = da + (rng.random(b) < flip_prob) * np.pi

    # dT: yaw da about the target centre c2, then translate by dt
    dT = get_mat_angle_batch(dt, da, c2)
    T_gt = get_mat_angle_batch(t, a, c1)
    M = np.einsum("nij,njk->nik", invert_rigid_batch(dT), T_gt)

    R = M[:, :3, :3]
    new_pc1 = (np.einsum("nij,nkj->nki", R, np.asarray(pc1, np.float64))
               + M[:, None, :3, 3])
    empty = ~np.any(np.asarray(pc1) != 0.0, axis=(1, 2))
    new_pc1[empty] = 0.0

    yaw_M = np.arctan2(M[:, 1, 0], M[:, 0, 0])
    new_c1 = np.einsum("nij,nj->ni", R, c1) + M[:, :3, 3]
    new_a1 = np.asarray(a1, np.float64).reshape(b) + yaw_M
    # the translation label re-based to the moved centre: T' = dT, so
    # t' = dT[:3, 3] - (c1' - Rz(da) c1')
    Rda = rotation_matrix_z(da)
    new_t = dT[:, :3, 3] - new_c1 + np.einsum("nij,nj->ni", Rda, new_c1)

    f32 = np.float32
    return (
        np.ascontiguousarray(new_pc1, f32), pc2,
        new_t.astype(f32),
        da.astype(f32).reshape(np.shape(batch[3])),
        new_c1.astype(f32),
        batch[5],
        new_a1.astype(f32).reshape(np.shape(batch[6])),
        batch[7],
    )
