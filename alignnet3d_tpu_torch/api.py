"""High-level alignment API on PyTorch.

Counterpart of ``alignnet3d_tpu/api.py``:

    from alignnet3d_tpu_torch.api import Aligner

    aligner = Aligner(spec, state_dict, device="cuda")
    # or a run of either package: config.json + model-*.pt or .msgpack
    aligner = Aligner.from_checkpoint("runs/X/config.json",
                                      "runs/X/model-59.msgpack")
    result = aligner.align(list_of_pc1, list_of_pc2, refine_icp=True)
    result["translations"], result["angles"], result["centers"]

Semantics match the JAX package: clouds are resampled with replacement to
the model's point count (the same numpy RNG calls in the same order, so a
seed gives the same clouds in both packages), the yaw is composed as
``decode(pc2) - decode(pc1) + decode(remaining)``, and the returned
translation acts about the returned centre
(``geometry.get_mat_angle(t, a, center)`` maps cloud1 onto cloud2).
The forward is the BN-folded serving engine; optional flip resolution,
gated network refinement and constrained ICP run on the same device.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import torch

from alignnet3d_tpu_torch import checkpoint, tracing
from alignnet3d_tpu_torch.config import config_from_dict
from alignnet3d_tpu_torch.data.denoise import component_filter_indices
from alignnet3d_tpu_torch.data.provider import voxel_dedup_indices
from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
from alignnet3d_tpu_torch.geometry import (
    compose_gated_refinement,
    get_mat_angle,
    get_mat_angle_batch,
    transform_points,
)
from alignnet3d_tpu_torch.icp.p2point import icp_p2point_batch
from alignnet3d_tpu_torch.models.alignnet import ModelSpec
from alignnet3d_tpu_torch.serving import build_inference_fn


class Aligner:
    def __init__(self, spec: ModelSpec, state_dict, batch_size: int = 128,
                 scale_residuals: bool = False, seed: int = 0,
                 voxel_resample: float | None = None,
                 denoise: tuple[float, str] | None = None, *,
                 device: torch.device | str):
        self.spec = spec
        # folded once here: later changes to ``state_dict`` have no effect
        self.state_dict = state_dict
        self.batch_size = batch_size
        self.residual_scale = np.pi / spec.num_bins if scale_residuals else 1.0
        # density-equalised serving input (training data.resample.mode=voxel)
        self.voxel_resample = voxel_resample
        # clutter rejection (cell_m, 'central'|'largest'), as training's
        # data.denoise: a model trained on filtered clouds serves on them
        self.denoise = denoise
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._forward = build_inference_fn(spec, state_dict, spec.dtype,
                                           device=self.device)
        self._alt_forwards: dict = {}

    @classmethod
    def from_checkpoint(cls, config_path: str, checkpoint_path: str,
                        device: torch.device | str = "cuda",
                        **kwargs) -> "Aligner":
        """Load a run's ``config.json`` and a ``model-*.pt`` (the port's)
        or ``model-*.msgpack`` (the JAX package's: full ``TrainState`` or
        bare variables), told apart by the suffix. As the JAX
        ``Aligner.from_checkpoint``, it takes ``evaluation.scale_residuals``
        and, unless ``kwargs`` set them, the voxel resampling
        (``data.resample.mode == "voxel"``) and the component filter
        (``data.denoise``) of the training data from the config."""
        with open(config_path) as f:
            cfg = config_from_dict(json.load(f))
        spec = ModelSpec.from_config(cfg)
        state_dict = checkpoint.state_dict_from_file(checkpoint_path)
        scale = bool(cfg.evaluation.has("scale_residuals")
                     and cfg.evaluation.scale_residuals)
        if ("voxel_resample" not in kwargs and cfg.data.has("resample")
                and cfg.data.resample.mode == "voxel"):
            rs = cfg.data.resample
            kwargs["voxel_resample"] = (rs.voxel_size
                                        if rs.has("voxel_size") else 0.05)
        if "denoise" not in kwargs and cfg.data.has("denoise"):
            dn = cfg.data.denoise
            kwargs["denoise"] = (dn.cell if dn.has("cell") else 0.5,
                                 dn.keep if dn.has("keep") else "central")
        return cls(spec, state_dict, scale_residuals=scale, device=device,
                   **kwargs)

    def _forward_for(self, state_dict):
        """Folded forward for an alternate weight set (e.g. a residual
        refiner), cached per object identity, at most 4 entries (FIFO)."""
        if state_dict is None:
            return self._forward
        key = id(state_dict)
        if key not in self._alt_forwards:
            while len(self._alt_forwards) >= 4:
                self._alt_forwards.pop(next(iter(self._alt_forwards)))
            self._alt_forwards[key] = build_inference_fn(
                self.spec, state_dict, self.spec.dtype, device=self.device)
        return self._alt_forwards[key]

    def _resample(self, clouds: Sequence[np.ndarray]) -> np.ndarray:
        """Uniform resample-with-replacement to the model point count: one
        RNG draw and one gather for the whole batch."""
        n = self.spec.num_points
        m = len(clouds)
        arrs = [np.asarray(c, np.float32).reshape(-1, np.shape(c)[-1]
                                                  if np.ndim(c) > 1 else 3)
                for c in clouds]
        lens = np.fromiter((len(a) for a in arrs), np.int64, m)
        total = int(lens.sum())
        if total == 0:
            return np.zeros((m, n, 3), np.float32)
        flat = np.concatenate([a[:, :3] for a in arrs if len(a)])
        if self.denoise is not None:
            cid = np.repeat(np.arange(m, dtype=np.int64), lens)
            kept = component_filter_indices(flat, cid, *self.denoise)
            flat = flat[kept]
            lens = np.bincount(cid[kept], minlength=m).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                return np.zeros((m, n, 3), np.float32)
        if self.voxel_resample:
            cid = np.repeat(np.arange(m, dtype=np.int64), lens)
            first = voxel_dedup_indices(flat, cid, self.voxel_resample)
            flat = flat[first]
            lens = np.bincount(cid[first], minlength=m).astype(np.int64)
            total = int(lens.sum())
        offs = np.zeros(m, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        # an empty cloud draws index 0 and is zeroed below
        idx = (self._rng.random((m, n)) * lens[:, None]).astype(np.int64)
        idx = np.minimum(idx, np.maximum(lens - 1, 0)[:, None])
        # an empty cloud that is not the first has offs == len(flat) when
        # it is last: clamp, its rows are zeroed anyway
        gather = np.minimum((idx + offs[:, None]).ravel(), total - 1)
        out = flat[gather].reshape(m, n, 3)
        if (lens == 0).any():
            out[lens == 0] = 0.0
        return np.ascontiguousarray(out, np.float32)

    def _predict(self, pcs1, pcs2, resolve_flips: bool, state_dict=None):
        """One forward sweep over all pairs: resample, batch, decode.
        Returns (translations (N,3), angles (N,), centers (N,3))."""
        n = len(pcs1)
        bs = self.batch_size
        forward = self._forward_for(state_dict)
        translations = np.empty((n, 3), np.float32)
        angles = np.empty(n, np.float32)
        centers = np.empty((n, 3), np.float32)

        for s in range(0, n, bs):
            e = min(s + bs, n)
            with tracing.span("api.resample"):
                a = self._resample(pcs1[s:e])
                b = self._resample(pcs2[s:e])
            pad = bs - (e - s)
            tracing.count("serving.rows", bs)
            tracing.count("serving.padded_rows", pad)
            with tracing.span("api.h2d"):  # pad to the batch, upload
                if pad:
                    a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                    b = np.concatenate([b, np.repeat(b[-1:], pad, 0)])
                a_dev = torch.from_numpy(a).to(self.device)
                b_dev = torch.from_numpy(b).to(self.device)
            with tracing.span("serving.forward"):
                out = forward(a_dev, b_dev)
            with tracing.span("api.readback"):
                out = {k: v.cpu().numpy() for k, v in out.items()}
            with tracing.span("api.decode"):
                dec = decode_pair_outputs(
                    out, a, b, self.spec.num_bins, self.residual_scale,
                    resolve_flips=resolve_flips, n=e - s, device=self.device)
                translations[s:e] = dec.translations
                angles[s:e] = dec.angles
                centers[s:e] = dec.s2_pc1centers
        return translations, angles, centers

    def align(self, pcs1: Sequence[np.ndarray], pcs2: Sequence[np.ndarray],
              refine_icp: bool = False, icp_its: int = 30,
              icp_radius: float = 0.1, resolve_flips: bool = False,
              network_refine: bool = False,
              refine_gate: tuple = (2.0, 0.15),
              refine_variables=None):
        """Align pairs of raw clouds. Returns a dict with ``translations``
        (N, 3), ``angles`` (N,), ``centers`` (N, 3) and ``transforms``
        (N, 4, 4).

        ``resolve_flips`` settles the 180-degree yaw ambiguity by chamfer
        comparison. ``network_refine`` runs a second forward pass on the
        coarsely aligned pair and composes its correction, accepted per pair
        only inside ``refine_gate`` (max |dyaw| deg, max |dxy| m);
        ``refine_variables`` optionally swaps in another ``state_dict`` for
        that pass. ``refine_icp`` then polishes every pair with constrained
        point-to-point ICP (world frame, centre = origin)."""
        if len(pcs1) != len(pcs2):
            raise ValueError(f"{len(pcs1)} first clouds but {len(pcs2)} second")
        with tracing.span("api.align"):
            n = len(pcs1)
            translations, angles, centers = self._predict(pcs1, pcs2,
                                                          resolve_flips)
            if network_refine and n:
                with tracing.span("api.network_refine"):
                    M1 = get_mat_angle_batch(translations, angles, centers)
                    pcs1_t = [
                        transform_points(np.asarray(p, np.float32)[:, :3],
                                         M1[i])
                        if len(p) else p
                        for i, p in enumerate(pcs1)
                    ]
                    t2, a2, c2 = self._predict(pcs1_t, pcs2, resolve_flips,
                                               state_dict=refine_variables)
                    M, _ = compose_gated_refinement(
                        M1, t2, a2, c2, refine_gate[0], refine_gate[1])
                    translations = M[:, :3, 3].astype(np.float32)
                    angles = np.arctan2(M[:, 1, 0], M[:, 0, 0]).astype(
                        np.float32)
                    centers = np.zeros_like(centers)
            if refine_icp:
                translations, angles, centers = self._refine_icp(
                    pcs1, pcs2, translations, angles, centers, icp_its,
                    icp_radius)
            with tracing.span("api.transforms"):
                transforms = np.stack([
                    get_mat_angle(translations[i], angles[i],
                                  rotation_center=centers[i])
                    for i in range(n)
                ])
        return {
            "translations": translations,
            "angles": angles,
            "centers": centers,
            "transforms": transforms,
        }

    def _refine_icp(self, pcs1, pcs2, translations, angles, centers,
                    its: int, radius: float):
        """Constrained point-to-point ICP from the given poses over the raw
        clouds, zero-padded to the longest (at most 4,096 points: longer
        clouds are subsampled without replacement from the aligner's
        generator). Returns the world-frame (translations, angles,
        centers)."""
        n = len(pcs1)
        with tracing.span("api.icp_pad"):
            n_max = max(max((len(p) for p in pcs1), default=1),
                        max((len(p) for p in pcs2), default=1))
            n_max = min(n_max, 4096)

            def pad_set(clouds):
                arr = np.zeros((n, n_max, 3), np.float32)
                msk = np.zeros((n, n_max), bool)
                for i, pc in enumerate(clouds):
                    pc = np.asarray(pc, np.float32)[:, :3]
                    if len(pc) > n_max:
                        pick = self._rng.choice(len(pc), n_max, replace=False)
                        pc = pc[pick]
                    arr[i, : len(pc)] = pc
                    msk[i, : len(pc)] = True
                return arr, msk

            src, sm = pad_set(pcs1)
            dst, dm = pad_set(pcs2)
            init = np.stack([
                get_mat_angle(translations[i], angles[i],
                              rotation_center=centers[i])
                for i in range(n)
            ])
        tf, _, _ = icp_p2point_batch(src, sm, dst, dm, init, radius=radius,
                                     its=its, device=self.device)
        return (tf[:, :3, 3].astype(np.float32),
                np.arctan2(tf[:, 1, 0], tf[:, 0, 0]).astype(np.float32),
                np.zeros_like(centers))
