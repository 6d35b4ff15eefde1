"""The train/eval loop: the port of ``alignnet3d_tpu/training/trainer.py``
(reference train.py:187-545).

What it keeps from the reference and the JAX package:
- staircase LR decay with a 1e-5 floor, Adam or momentum SGD; the LR
  applied is read at the optimizer's own count before the update (optax's
  ``ScaleByScheduleState.count``), which a pretraining restore keeps, and
  the LR logged at the step (``learning_rate(step)``), which it resets;
- the scheduled BN momentum fed into every ``EmaBatchNorm`` each step;
- per epoch a shuffled drop-remainder training epoch, then a full val-set
  eval writing eval.json + eval_180.json and the 8 pred_*.npy arrays;
- checkpoints: rolling ``model.ckpt`` every 2 epochs, numbered
  ``model-<E>`` every 5 (or every epoch with evaluation.save_every_epoch)
  and on the last; resume from the rolling one with the epoch-alignment
  assert; ``training.pretraining.model`` restores all but the step and
  runs an eval tagged 'pretr';
- the residual-alignment task (data.residual_task) on train and eval
  batches;
- JSONL scalar files train/val/val_180 with the reference's tags;
- the eval-time stack: the component filter and voxel views of the
  dataset (data.denoise, data.resample), a gated second network pass
  (evaluation.network_refine), gated ICP refinement with an optional
  cascade of stages (refine_icp, evaluation.refinement*), stored
  predictions (use_old_results) and timing mode (do_timings);
- the velocity-only eval of Held-style tracking data
  (evaluation.special.mode 'held', ``metrics.evaluate_held``);
- ``tpu.profile`` = {"dir", "steps"}: a profiler trace of steps 1 to
  ``steps`` of epoch 0 (step 0 is skipped, as in the JAX package), here a
  ``torch.profiler`` Chrome trace (host and, on the card, CUDA activity)
  written under ``dir``, which holds the port's spans (``tracing.py``:
  ``trainer.train_step`` and its stages, ``data.*``).

In PyTorch: checkpoints are written as ``.pt`` (``checkpoint.py``), named
as the JAX package's with ``.pt`` for ``.msgpack``; every restore reads
either format, a name without a suffix taking ``.pt`` when it exists, else
``.msgpack``, so a run of the JAX package resumes, evaluates, fine-tunes
or refines here. The input jitter (sigma 0.01, clipped at 0.05)
is drawn on the device from a ``torch.Generator`` seeded from ``seed``,
and dropout from another. Batches come from ``PackedDataset.sample_batch``
(the native assembler by default, as in the JAX package) behind a
background prefetch thread; the per-step scalars stay on the device until
one readback at the end of the epoch.

Several processes (``parallel/multihost.py``, one a card) train one model
data-parallel, as the JAX package's processes do over its mesh: each takes
the strided shard of the epoch order (``PackedDataset.shard_indices``) and
draws its ``batch_size / processes`` rows of each global batch from the
epoch's generator; the model is wrapped in ``DistributedDataParallel``;
the BN statistics and the loss are those of the global batch
(``models/batchnorm.py``, ``models/losses.py``, the fused edge stage), and
the jitter and dropout are drawn for the global batch on every process,
each keeping its rows, so P processes take the step one process takes on
that global batch. Only process 0 writes artifacts, scalar files, the
config copy and checkpoints; the others log to ``{logdir}/proc{i}``.
Restores read the file on process 0 and broadcast it. Eval runs each
process's rows of the full batch and gathers the outputs; flip resolution,
ICP and the metrics run on process 0, and the network refine pass refuses
more than one process.

The standalone baselines (evaluation.special.mode 'icp') run through the
CLI (``icp/runner.py``), not through ``Trainer``, which refuses them; the
'mp' mesh axis and ``tpu.steps_per_dispatch`` are TPU-only and have no
counterpart here.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.profiler
from torch.nn.parallel import DistributedDataParallel

from alignnet3d_tpu_torch import checkpoint, tracing
from alignnet3d_tpu_torch.data import provider
from alignnet3d_tpu_torch.data.residual import (
    apply_residual_task,
    params_from_config,
)
from alignnet3d_tpu_torch.evaluation import metrics as evaluation
from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
from alignnet3d_tpu_torch.geometry import (
    compose_gated_refinement,
    get_mat_angle_batch,
)
from alignnet3d_tpu_torch.icp.p2point import refine_predictions
from alignnet3d_tpu_torch.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu_torch.models.backbones import Dropout
from alignnet3d_tpu_torch.models.losses import LossSpec, get_loss
from alignnet3d_tpu_torch.parallel import mesh, multihost
from alignnet3d_tpu_torch.training import schedules
from alignnet3d_tpu_torch.weights import init_state_dict

logger = logging.getLogger("alignnet3d_tpu_torch")


def setup_logging(logdir: str):
    """stdout (INFO) + a DEBUG file log, ``out.log`` or a timestamped name
    when one exists (reference train.py:84-111)."""
    os.makedirs(logdir, exist_ok=True)
    root = logging.getLogger("alignnet3d_tpu_torch")
    root.setLevel(logging.DEBUG)
    root.handlers = [h for h in root.handlers if not isinstance(
        h, (logging.StreamHandler, logging.FileHandler))]
    fmt = logging.Formatter(
        "%(asctime)s %(name)-12s %(levelname)-8s %(message)s",
        "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    logfile = f"{logdir}/out.log"
    if os.path.exists(logfile):
        datestr = datetime.datetime.today().strftime("%Y-%m-%d_%H-%M-%S")
        logfile = f"{logfile[:-4]}_{datestr}.log"
    fh = logging.FileHandler(logfile)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    root.addHandler(fh)


def progress(iterable, desc: str = "", total=None):
    """Iterate over ``iterable`` and log, when it ends or is left, how many
    items it gave and at what rate (the closing line of the reference's
    tqdm bar, train.py:114-126)."""
    t0, n = time.perf_counter(), 0
    try:
        for item in iterable:
            yield item
            n += 1
    finally:
        if total:
            dt = time.perf_counter() - t0
            logger.debug("progress %s: %d/%d in %.2f s (%.2f it/s)", desc, n,
                         total, dt, n / dt if dt > 0 else 0.0)


class ScalarWriter:
    """JSONL scalar event writer, the TensorBoard-summary equivalent (tags
    of reference train.py:517-531)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path

    def write(self, step: int, scalars: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **{
                k: float(v) for k, v in scalars.items()}}) + "\n")

    def write_rows(self, steps, stacked: dict):
        """One row per step from a dict of equal-length arrays."""
        keys = list(stacked)
        with open(self.path, "a") as f:
            for i, step in enumerate(steps):
                f.write(json.dumps({"step": int(step), **{
                    k: float(stacked[k][i]) for k in keys}}) + "\n")


def cascade_stage_kwargs(base_kwargs: dict, stage: dict) -> dict:
    """``refine_predictions`` kwargs of one cascade stage dict ({radius?,
    method?, max_dyaw_deg?, max_dxy?}). A stage that sets its own trust
    region turns its gate on: otherwise its max_dyaw_deg / max_dxy would
    be dead whenever evaluation.refinement_gate is off."""
    kwargs = dict(base_kwargs)
    if "radius" in stage:
        kwargs["radius"] = stage["radius"]
    if "method" in stage:
        kwargs["method"] = stage["method"]
    for src, dst in (("max_dyaw_deg", "gate_max_dyaw_deg"),
                     ("max_dxy", "gate_max_dxy")):
        if src in stage:
            kwargs[dst] = stage[src]
            kwargs["gate"] = True
    return kwargs


def _check_mode(cfg):
    """Raise on a special evaluation mode that ``Trainer`` does not run."""
    ev = cfg.evaluation
    if ev.has("special") and ev.special.mode not in ("timings", "held"):
        raise NotImplementedError(
            f"evaluation.special (mode {ev.special.mode!r}) does not run "
            f"through Trainer: 'icp' runs through alignnet3d_tpu_torch.cli "
            f"(icp/runner.py)")


class _StepProfile:
    """A ``torch.profiler`` trace of a run of training steps, written as
    a Chrome trace under ``directory`` when it stops."""

    def __init__(self, directory: str, device: torch.device):
        self.directory = directory
        self.device = device
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def stop(self, first: int, last: int) -> str:
        """End the trace after the steps ``first``..``last`` of epoch 0;
        returns the trace file's path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"train_epoch0_steps{first}-{last}.json")
        self._prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")
        return path


class Trainer:
    """``Trainer(cfg, seed, device=...).train()``. ``device`` is required:
    ``"cuda"`` trains on the card through its kernels (with several
    processes, this process's card), ``"cpu"`` runs the kernels' plain
    twins."""

    # this process's rows of a training batch when several processes train
    _rows: multihost.RowShard | None = None

    def __init__(self, cfg: Any, seed: int = 0, *,
                 device: torch.device | str):
        _check_mode(cfg)
        self.cfg = cfg
        self.seed = seed
        self.device = multihost.local_device(device)
        self.spec = ModelSpec.from_config(cfg)
        self.loss_spec = LossSpec.from_config(cfg)
        self.model = AlignNet(self.spec).to(self.device)
        self.logdir = cfg.logging.logdir
        self.batch_size = cfg.training.batch_size
        # several processes: this one holds 1/num_processes of every batch
        self.num_processes = multihost.process_count()
        self.process_index = multihost.process_index()
        self.is_main_process = self.process_index == 0
        mesh.data_parallel_width(cfg, self.batch_size, self.num_processes)
        self.local_batch_size = self.batch_size // self.num_processes
        self.train_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/train.txt")
        self.val_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/val.txt")
        self.num_batches_per_epoch = len(self.train_indices) // self.batch_size
        self.dataset = provider.PackedDataset(cfg.data.basepath)
        # clutter rejection (data.denoise = {"cell": 0.5, "keep":
        # "central"|"largest"}); it must precede the voxel view
        if cfg.data.has("denoise"):
            dn = cfg.data.denoise
            self.dataset.enable_component_filter(
                dn.cell if dn.has("cell") else 0.5,
                dn.keep if dn.has("keep") else "central")
        # density-equalised resampling (data.resample = {"mode": "voxel",
        # "voxel_size": 0.05}); by default the reference's uniform
        # resample-with-replacement (provider.py:97-98)
        if cfg.data.has("resample") and cfg.data.resample.mode == "voxel":
            rs = cfg.data.resample
            self.dataset.enable_voxel_resample(
                rs.voxel_size if rs.has("voxel_size") else 0.05)
        self._refine_model = None  # (weights path, model) of network_refine
        self._residual_params = params_from_config(cfg)
        self._data_rng = np.random.default_rng(seed + 1)
        self._jitter_gen = torch.Generator(self.device).manual_seed(seed + 2)
        dropout_gen = torch.Generator(self.device).manual_seed(seed + 3)
        # the jitter and the dropout masks are drawn for the global batch,
        # and each process keeps its rows
        if self.num_processes > 1:
            self._rows = multihost.RowShard(
                self.process_index * self.local_batch_size,
                self.local_batch_size, self.batch_size)
        for module in self.model.modules():
            if isinstance(module, Dropout):
                module.generator = dropout_gen
                module.rows = self._rows
        # the module a training step runs: the model, or with several
        # processes its DistributedDataParallel wrapper (which averages the
        # gradients; each process's BN running statistics are already the
        # global batch's, so no buffer is broadcast). A completion head
        # whose loss is off gets no gradient.
        self._train_module = self.model
        if self.num_processes > 1:
            self._train_module = DistributedDataParallel(
                self.model, broadcast_buffers=False,
                find_unused_parameters=(
                    self.spec.completion_points > 0
                    and self.loss_spec.completion_weight == 0.0))
        self.optimizer = None
        self.step = 0
        # the optimizer's own update count, which the applied LR is read
        # at (optax's ScaleByScheduleState.count): it equals ``step`` but
        # for a pretraining restore, which resets ``step`` only
        self.schedule_count = 0
        # the trace files written by tpu.profile
        self.profile_traces: list[str] = []

    # ------------------------------------------------------------ building

    def _make_optimizer(self) -> torch.optim.Optimizer:
        opt = self.cfg.training.optimizer
        params = list(self.model.parameters())
        lr = schedules.learning_rate(0, self.cfg, self._nbpe)
        if opt.optimizer == "adam":
            return torch.optim.Adam(params, lr=lr)
        if opt.optimizer == "momentum":
            return torch.optim.SGD(params, lr=lr, momentum=opt.momentum)
        raise ValueError(f"Invalid optimizer {opt.optimizer!r}")

    @property
    def _nbpe(self) -> int:
        return max(1, self.num_batches_per_epoch)

    def init_state(self):
        """Seeded weights (``weights.init_state_dict``), a fresh optimizer
        and step 0."""
        self.model.load_state_dict(init_state_dict(self.spec, self.seed))
        self.optimizer = self._make_optimizer()
        self.step = 0
        self.schedule_count = 0

    # ---------------------------------------------------------- the steps

    def _to_device(self, batch):
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
                     for a in batch)

    def _jitter(self, pcs: torch.Tensor) -> torch.Tensor:
        """Per-point gaussian jitter, sigma 0.01 clipped at 0.05 (reference
        provider.py:60-71), drawn on the device (for the global batch, of
        which this process keeps its rows)."""
        def draw(shape):
            return torch.randn(shape, generator=self._jitter_gen,
                               device=self.device)

        noise = (draw(pcs.shape) if self._rows is None
                 else self._rows.take(draw, pcs.shape))
        return pcs + torch.clamp(0.01 * noise, -0.05, 0.05)

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch; returns its scalars, the
        losses as device tensors."""
        with tracing.span("trainer.train_step"):
            with tracing.span("trainer.to_device"):
                pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = \
                    self._to_device(batch)
            with tracing.span("trainer.jitter"):
                pcs1, pcs2 = self._jitter(pcs1), self._jitter(pcs2)
            with tracing.span("trainer.forward"):
                bn_m = schedules.bn_decay(self.step, self.cfg, self._nbpe)
                self._train_module.train()
                out = self._train_module(pcs1, pcs2, momentum=bn_m)
            with tracing.span("trainer.loss"):
                loss, aux = get_loss(pcs1, pcs2, translations, rel_angles,
                                     c1, c2, a1, a2, out, spec=self.loss_spec)
            with tracing.span("trainer.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with tracing.span("trainer.optimizer"):
                lr = schedules.learning_rate(self.schedule_count, self.cfg,
                                             self._nbpe)
                logged_lr = schedules.learning_rate(self.step, self.cfg,
                                                    self._nbpe)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
                self.step += 1
                self.schedule_count += 1
            return {"losses/loss": loss.detach(),
                    "hyperparameters/learning_rate": logged_lr,
                    "hyperparameters/bn_decay": bn_m,
                    **{k: v.detach() for k, v in aux.items()}}

    @torch.no_grad()
    def eval_step(self, batch, model=None):
        """(loss, end_points as numpy) of the eval-mode model (by default
        the trained one). With several processes ``batch`` is this
        process's rows, the loss is the global batch's and the end points
        are every process's rows, gathered in process order."""
        pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = \
            self._to_device(batch)
        model = self.model if model is None else model
        model.eval()
        out = model(pcs1, pcs2)
        loss, _ = get_loss(pcs1, pcs2, translations, rel_angles, c1, c2, a1,
                           a2, out, spec=self.loss_spec)
        return float(loss), {k: multihost.all_gather_rows(v).cpu().numpy()
                             for k, v in out.items()}

    # -------------------------------------------------------- checkpoints

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}.pt")

    def save_checkpoint(self, name: str) -> str:
        """Write the checkpoint ``name`` (process 0 only: every process
        holds the same state)."""
        path = self._ckpt_path(name)
        if not self.is_main_process:
            return path
        checkpoint.save(path, self.model, self.optimizer, self.step,
                        self.schedule_count)
        logger.info(f"Model saved in file: {path}")
        return path

    def _find_checkpoint(self, path: str) -> str | None:
        """Process 0's ``checkpoint.find(path)``, on every process."""
        return multihost.broadcast_tree(
            checkpoint.find(path) if self.is_main_process else None)

    def restore_checkpoint(self, path: str, except_step: bool = False):
        """Restore a ``.pt`` or ``.msgpack`` (a path without a suffix takes
        ``.pt`` when it exists, else ``.msgpack``): the weights, the
        optimizer's state and its count, and, unless ``except_step`` (a
        pretraining restore), the step. Returns the path read. Process 0
        reads the file and broadcasts what it read to the other processes."""
        found = self._find_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint: {path} on process 0")
        path = found
        state = None
        if self.is_main_process:
            restored = checkpoint.load(path, self.model, self.optimizer)
            state = (restored, self.model.state_dict(),
                     self.optimizer.state_dict())
        restored, weights, opt_state = multihost.broadcast_tree(state)
        if not self.is_main_process:
            self.model.load_state_dict(weights)
            self.optimizer.load_state_dict(opt_state)
        self.schedule_count = restored["schedule_count"]
        if not except_step:
            if restored["step"] is None:
                raise ValueError(f"{path} holds weights only, no training "
                                 f"step to resume from")
            self.step = restored["step"]
        return path

    # ------------------------------------------------------------- epochs

    def _make_batch(self, indices, rng: np.random.Generator | None = None):
        rng = self._data_rng if rng is None else rng
        batch = self.dataset.sample_batch(indices, self.spec.num_points, rng)
        if self._residual_params is not None:
            batch = apply_residual_task(batch, rng, **self._residual_params)
        return batch

    def _epoch_rng(self, *tags) -> np.random.Generator:
        """A fresh generator per (seed, tags): the prefetch thread owns it,
        and an aborted epoch leaves no shared stream mid-way."""
        ints = [self.seed]
        for t in tags:
            try:
                ints.append(int(t))
            except (TypeError, ValueError):  # string epoch tags ('pretr')
                ints.extend(str(t).encode("utf8"))
        return np.random.default_rng(np.random.SeedSequence(ints))

    def train_one_epoch(self, epoch: int, writer: ScalarWriter):
        """Shuffled drop-remainder epoch (reference train.py:335-383), with
        a guard that stops the run on a non-finite loss, and in epoch 0 the
        ``tpu.profile`` trace of steps 1 to ``tpu.profile.steps``."""
        epoch_rng = self._epoch_rng(1, epoch)
        idxs = np.asarray(self.train_indices).copy()
        epoch_rng.shuffle(idxs)
        num_batches = len(idxs) // self.batch_size
        if self.num_processes > 1:
            # this process's shard of the (identically shuffled) epoch
            # order; it assembles only its own rows of each global batch
            idxs = np.asarray(provider.PackedDataset.shard_indices(
                idxs, self.process_index, self.num_processes))
        bs = self.local_batch_size
        prefetch = (self.cfg.tpu.prefetch_batches if self.cfg.has("tpu")
                    else 2)
        profile_cfg = (self.cfg.tpu.profile if self.cfg.has("tpu")
                       and self.cfg.tpu.has("profile") else None)
        profile_steps = (int(profile_cfg.steps)
                         if profile_cfg is not None and epoch == 0
                         and self.is_main_process else 0)

        def make(i):
            return self._make_batch(idxs[i * bs:(i + 1) * bs], rng=epoch_rng)

        step_metrics = []
        profile = None
        try:
            for batch_idx, batch in enumerate(progress(
                    provider.PrefetchIterator(make, num_batches, prefetch),
                    desc=f"train epoch {epoch}", total=num_batches)):
                if profile_steps and batch_idx == 1:  # step 0 warms up
                    profile = _StepProfile(profile_cfg.dir, self.device)
                step_metrics.append(self.train_step(batch))
                if profile is not None and batch_idx >= profile_steps:
                    self.profile_traces.append(profile.stop(1, batch_idx))
                    profile = None
        finally:
            if profile is not None:  # the epoch ended first, or a step raised
                self.profile_traces.append(profile.stop(1, batch_idx))
        if not step_metrics:
            return
        keys = list(step_metrics[0])
        on_device = [k for k in keys if isinstance(step_metrics[0][k],
                                                   torch.Tensor)]
        # one readback for the whole epoch
        values = torch.stack([torch.stack([m[k] for k in on_device])
                              for m in step_metrics]).cpu().numpy()
        stacked = {k: (values[:, on_device.index(k)] if k in on_device
                       else np.asarray([m[k] for m in step_metrics]))
                   for k in keys}
        loss_vals = stacked["losses/loss"]
        bad = ~np.isfinite(loss_vals)
        if bad.any():
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} step "
                f"{int(np.argmax(bad))} (value {loss_vals[np.argmax(bad)]}); "
                f"last good checkpoint is in {self.logdir}")
        if writer is not None:
            writer.write_rows(range(self.step - num_batches + 1,
                                    self.step + 1), stacked)
        logger.info("train mean loss: %f"
                    % (float(loss_vals.sum()) / num_batches))

    def _refine_weights_model(self, weights: str):
        """The model of a network_refine ``weights`` checkpoint (a path
        without a suffix, as training.pretraining.model: ``.pt`` or else
        ``.msgpack``), cached: during training the pass runs every eval
        epoch."""
        if self._refine_model is None or self._refine_model[0] != weights:
            model = AlignNet(self.spec).to(self.device)
            model.load_state_dict(checkpoint.state_dict_from_file(
                weights, self.device))
            self._refine_model = (weights, model)
        return self._refine_model[1]

    def _network_refine_pass(self, P, val_idxs, batch_size, residual_scale,
                             net_ref, resolve_flips: bool = True,
                             iteration: int = 0):
        """Second forward pass on the coarsely aligned pair
        (evaluation.network_refine): move pc1 by the first pass's composed
        transform M1, predict again, compose dM @ M1, and accept the update
        per pair only inside the trust region (|da| <= gate max_dyaw_deg,
        default 2.0; |dxy| <= max_dxy, default 0.15 m): an out-of-basin
        second pass must not throw away a good init.

        Rewrites P's final transform in the world frame (rotation centre
        zero, as ICP refinement, reference train.py:483-484); the s1/s2
        diagnostic arrays keep the first pass's values. An optional
        ``weights`` key names a checkpoint whose model runs this pass."""
        n = len(val_idxs)
        nb = self.spec.num_bins
        gate = net_ref.gate if net_ref.has("gate") else None
        gate_deg = (gate.max_dyaw_deg
                    if gate is not None and gate.has("max_dyaw_deg") else 2.0)
        gate_xy = (gate.max_dxy
                   if gate is not None and gate.has("max_dxy") else 0.15)
        # the residual rewrite would compose a second random pre-alignment
        # on top of M1 in the batches below
        if self._residual_params is not None:
            raise ValueError(
                "evaluation.network_refine and data.residual_task are "
                "mutually exclusive in one config: point network_refine at "
                "the residual-trained weights instead (weights key)")
        model = (self._refine_weights_model(net_ref.weights)
                 if net_ref.has("weights") and net_ref.weights else None)
        M1 = get_mat_angle_batch(P["pred_translations"],
                                 P["pred_angles"][:, 0],
                                 P["pred_s2_pc1centers"])
        # a fixed stream per pass (pass 1 of the eval loop draws from (2))
        rng = self._epoch_rng(2, 1 + iteration)
        t2 = np.empty((n, 3), np.float32)
        a2 = np.empty(n, np.float64)
        c2 = np.empty((n, 3), np.float32)
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            take = val_idxs[s:e] + [val_idxs[0]] * (batch_size - (e - s))
            batch = self._make_batch(take, rng=rng)
            Mb = M1[s:e]
            if batch_size > e - s:  # the padded tail moves by identity
                Mb = np.concatenate(
                    [Mb, np.tile(np.eye(4), (batch_size - (e - s), 1, 1))])
            pc1 = (np.einsum("bij,bnj->bni",
                             Mb[:, :3, :3].astype(np.float32), batch[0])
                   + Mb[:, None, :3, 3].astype(np.float32))
            # empty clouds stay zero (reference provider.py:95-96)
            empty = ~np.any(batch[0] != 0.0, axis=(1, 2))
            pc1[empty] = 0.0
            pc1 = pc1.astype(np.float32)
            _, out = self.eval_step((pc1,) + tuple(batch[1:]), model)
            # the decode policy of pass 1: mixing policies would let the
            # mod-pi gate accept pi-sized "corrections"
            dec = decode_pair_outputs(out, pc1, batch[1], nb, residual_scale,
                                      resolve_flips=resolve_flips, n=e - s,
                                      device=self.device)
            t2[s:e] = dec.translations
            a2[s:e] = dec.angles
            c2[s:e] = dec.s2_pc1centers
        M, ok = compose_gated_refinement(M1, t2, a2, c2, gate_deg, gate_xy)
        logger.info(f"network refine: accepted {int(ok.sum())}/{n} "
                    f"(gate {gate_deg} deg / {gate_xy} m)")
        P["pred_translations"] = M[:, :3, 3].astype(np.float32)
        P["pred_angles"] = np.arctan2(M[:, 1, 0], M[:, 0, 0]).astype(
            np.float32).reshape(n, 1)
        P["pred_s2_pc1centers"] = np.zeros((n, 3), np.float32)
        return P

    def _refine_icp(self, P, val_idxs, icp_its: int, icp_method: str):
        """Gated ICP refinement of P's final transforms, in one or more
        cascade stages (evaluation.refinement.cascade: a list of {radius?,
        its?, method?, max_dyaw_deg?, max_dxy?}); each stage starts from
        the previous stage's world-frame output. Returns the ICP seconds."""
        ev = self.cfg.evaluation
        gate_cfg = ev.refinement_gate if ev.has("refinement_gate") else None
        base = {}
        if gate_cfg is not None and gate_cfg.enabled:
            base["gate"] = True
            if gate_cfg.has("max_dyaw_deg"):
                base["gate_max_dyaw_deg"] = gate_cfg.max_dyaw_deg
            if gate_cfg.has("max_dxy"):
                base["gate_max_dxy"] = gate_cfg.max_dxy
        # the reference hardwires radius=0.1 (train.py:469)
        ref_cfg = ev.refinement if ev.has("refinement") else None
        if ref_cfg is not None and ref_cfg.has("radius"):
            base["radius"] = ref_cfg.radius
        base["method"] = icp_method
        stages = (ref_cfg.cascade
                  if ref_cfg is not None and ref_cfg.has("cascade") else None)
        cur_t = P["pred_translations"]
        cur_a = P["pred_angles"]
        cur_c = P["pred_s2_pc1centers"]
        seconds = 0.0
        for stage in stages or [{}]:
            with tracing.span("eval.icp_stage"):
                refined, elapsed = refine_predictions(
                    self.cfg, val_idxs, cur_t, cur_a, cur_c,
                    its=int(stage.get("its", icp_its)), dataset=self.dataset,
                    device=self.device, **cascade_stage_kwargs(base, stage))
            cur_t, cur_a = refined["translations"], refined["angles"]
            # ICP transforms are world-frame: the rotation centre resets to
            # the origin (reference train.py:483-484)
            cur_c = np.zeros_like(cur_c)
            seconds += elapsed
        P["pred_translations"] = cur_t
        P["pred_angles"] = cur_a
        P["pred_s2_pc1centers"] = cur_c
        return seconds

    def eval_one_epoch(self, epoch, eval_only: bool,
                       do_timings: bool = False, override_batch_size=None,
                       refine_icp: bool = False, icp_its: int = 30,
                       icp_method: str = "p2p",
                       use_old_results: bool = False,
                       val_writer: ScalarWriter | None = None,
                       val_writer_180: ScalarWriter | None = None) -> float:
        """Eval of the full val set, both eval files and the prediction
        arrays (reference train.py:386-545), then the optional second
        network pass and ICP refinement. ``use_old_results`` reads the
        final transforms of an earlier eval of this epoch instead of
        running the network; ``do_timings`` prints the mean time a pair
        and writes no eval files."""
        cfg = self.cfg
        batch_size = override_batch_size or self.batch_size
        val_idxs = list(self.val_indices)
        n_val = len(val_idxs)
        num_batches = int(np.ceil(n_val / batch_size))
        num_full_batches = n_val // batch_size
        net_ref = (cfg.evaluation.network_refine
                   if cfg.evaluation.has("network_refine") else None)
        run_net_ref = (net_ref is not None and net_ref.enabled
                       and not use_old_results and not do_timings)
        if self.num_processes > 1:
            if batch_size % self.num_processes != 0:
                raise ValueError(f"eval batch size {batch_size} must divide "
                                 f"over {self.num_processes} processes")
            # the pass consumes process 0's flip-resolved predictions
            if run_net_ref:
                raise ValueError(
                    "evaluation.network_refine is single-process (pod eval "
                    "runs the coarse pass everywhere; refine after gather)")
        local_bs = batch_size // self.num_processes
        lo = self.process_index * local_bs
        # one fixed stream: a checkpoint gives the same predictions in any
        # eval, and val curves carry no resampling noise
        eval_rng = self._epoch_rng(2)
        # the refinement method: the caller's, unless the config names one
        if cfg.evaluation.has("refinement") and \
                cfg.evaluation.refinement.has("method"):
            icp_method = cfg.evaluation.refinement.method
        eval_dir = f"{self.logdir}/val/eval{str(epoch).zfill(6)}"
        base_eval_dir = eval_dir
        if refine_icp:
            suffix = f"_{icp_its}" if icp_its != 30 else ""
            eval_dir = f"{eval_dir}/refined_{icp_method}{suffix}"
        if self.is_main_process and os.path.isdir(eval_dir):
            backup = f"{eval_dir}_backup_{int(time.time())}"
            k = 0
            while os.path.exists(backup):
                k += 1
                backup = f"{eval_dir}_backup_{int(time.time())}_{k}"
            os.rename(eval_dir, backup)
        if self.is_main_process:
            os.makedirs(eval_dir, exist_ok=True)

        P = {k: np.empty((n_val, d), dtype=np.float32) for k, d in [
            ("pred_translations", 3), ("pred_angles", 1),
            ("pred_s1_pc1centers", 3), ("pred_s1_pc2centers", 3),
            ("pred_s2_pc1centers", 3), ("pred_s2_pc2centers", 3),
            ("pred_s2_pc1angles", 1), ("pred_s2_pc2angles", 1)]}
        G = {"gt_translations": np.empty((n_val, 3), np.float32),
             "gt_angles": np.empty((n_val, 1), np.float32),
             "gt_pc1centers": np.empty((n_val, 3), np.float32)}
        if use_old_results and self.is_main_process:
            # the final transform only; the other five arrays stay unset,
            # as in the JAX package
            for key in ("pred_translations", "pred_angles",
                        "pred_s2_pc1centers"):
                P[key] = np.load(f"{base_eval_dir}/{key}.npy")
        nb = self.spec.num_bins
        # the reference decodes the residuals unscaled (tp8.py:241-244);
        # evaluation.scale_residuals opts into the consistent decode
        residual_scale = (np.pi / nb if cfg.evaluation.has("scale_residuals")
                          and cfg.evaluation.scale_residuals else 1.0)
        # the flips feed process 0's artifacts only
        resolve_flips = bool(cfg.evaluation.has("resolve_flips")
                             and cfg.evaluation.resolve_flips
                             and self.is_main_process)
        loss_sum, cumulated_times = 0.0, 0.0
        for batch_idx in progress(range(num_batches),
                                  desc=f"eval epoch {epoch}",
                                  total=num_batches):
            start = batch_idx * batch_size
            end = min(start + batch_size, n_val)
            actual = end - start
            # pad to a full batch (the reference feeds a stale tail)
            padded = val_idxs[start:end] + [val_idxs[0]] * (batch_size - actual)
            # every process assembles the full batch (its labels and clouds
            # feed the decode) and runs its own rows of it
            batch = self._make_batch(padded, rng=eval_rng)
            if not use_old_results:
                t0 = time.time()
                loss_val, out = self.eval_step(
                    batch if self.num_processes == 1
                    else tuple(a[lo:lo + local_bs] for a in batch))
                cumulated_times += time.time() - t0
                if actual == batch_size:
                    loss_sum += loss_val
                t0 = time.time()
                dec = decode_pair_outputs(out, batch[0], batch[1], nb,
                                          residual_scale,
                                          resolve_flips=resolve_flips,
                                          n=actual, device=self.device)
                if resolve_flips:
                    cumulated_times += time.time() - t0
                P["pred_translations"][start:end] = dec.translations
                P["pred_angles"][start:end, 0] = dec.angles
                for key in ("pred_s1_pc1centers", "pred_s1_pc2centers",
                            "pred_s2_pc1centers", "pred_s2_pc2centers"):
                    P[key][start:end] = out[key][:actual]
                P["pred_s2_pc1angles"][start:end, 0] = dec.ang1
                P["pred_s2_pc2angles"][start:end, 0] = dec.ang2
            G["gt_translations"][start:end] = batch[2][:actual]
            G["gt_angles"][start:end] = batch[3][:actual]
            G["gt_pc1centers"][start:end] = batch[4][:actual]

        if not self.is_main_process:
            # the artifacts, metrics, refinement and scalar rows are process
            # 0's; the collective work above ran on every process
            return loss_sum / num_full_batches if num_full_batches else 0.0
        if run_net_ref:
            # iterations > 1 compose from the GATED chain each pass (P is
            # rewritten in place), so deeper passes stay frame-consistent
            t0 = time.time()
            with tracing.span("eval.network_refine"):
                for itn in range(int(net_ref.iterations)
                                 if net_ref.has("iterations") else 1):
                    P = self._network_refine_pass(
                        P, val_idxs, batch_size, residual_scale, net_ref,
                        resolve_flips=resolve_flips, iteration=itn)
            cumulated_times += time.time() - t0
        if refine_icp:
            cumulated_times += self._refine_icp(P, val_idxs, icp_its,
                                                icp_method)

        mean_loss = loss_sum / num_full_batches if num_full_batches else 0.0
        mean_time = cumulated_times / float(n_val)
        held = (cfg.evaluation.has("special")
                and cfg.evaluation.special.mode == "held")
        metas = self.dataset.metas(val_idxs)
        if do_timings:
            print(f"Timing bs={batch_size}: {mean_time}")
        elif held:
            evaluation.evaluate_held(
                cfg, val_idxs, P["pred_translations"], P["pred_angles"],
                G["gt_translations"], G["gt_angles"], eval_dir=eval_dir,
                mean_time=mean_time, metas=metas)
        for accept_inverted, writer in (() if do_timings or held else (
                (False, val_writer), (True, val_writer_180))):
            ev = evaluation.evaluate(
                cfg, val_idxs, P["pred_translations"], P["pred_angles"],
                G["gt_translations"], G["gt_angles"],
                P["pred_s2_pc1centers"], G["gt_pc1centers"],
                eval_dir=eval_dir, accept_inverted_angle=accept_inverted,
                mean_time=mean_time, metas=metas)
            levels = {name: " ".join(f"{a * 100.0:.2f}%" for a in vals)
                      for name, vals in (
                          ("all", ev.corr_levels),
                          ("t", ev.corr_levels_translation),
                          ("a", ev.corr_levels_angles))}
            logger.info(
                f"Mean translation distance: {ev.mean_dist_translation},"
                f" Mean angle distance: {ev.mean_dist_angle},"
                f" Levels: {levels['all']}, Translation levels: {levels['t']},"
                f" Angle levels: {levels['a']}, Mean ex. time: "
                f"{mean_time:.5f}")
            if not eval_only and writer is not None:
                writer.write(self.step, {
                    "losses/loss": mean_loss,
                    "accuracy/t_a_mean_dist": ev.mean_dist_translation,
                    "accuracy/t_b_1cm": ev.corr_levels_translation[0],
                    "accuracy/t_c_10cm": ev.corr_levels_translation[1],
                    "accuracy/t_d_1m": ev.corr_levels_translation[2],
                    "accuracy/a_a_mean_dist": ev.mean_dist_angle,
                    "accuracy/a_b_1d": ev.corr_levels_angles[0],
                    "accuracy/a_c_5d": ev.corr_levels_angles[1],
                    "accuracy/a_d_10d": ev.corr_levels_angles[2],
                    "accuracy/o_b_1cm": ev.corr_levels[0],
                    "accuracy/o_c_10cm": ev.corr_levels[1],
                    "accuracy/o_d_1m": ev.corr_levels[2],
                    "accuracy/fitness": ev.reg_eval.fitness,
                    "accuracy/inlier_rmse": ev.reg_eval.inlier_rmse,
                })
        for name, arr in P.items():
            np.save(f"{eval_dir}/{name}.npy", arr)
        logger.info("val mean loss: %f" % mean_loss)
        return mean_loss

    # --------------------------------------------------------- entry point

    def train(self, eval_only: bool = False, eval_epoch=None,
              refine_icp: bool = False, icp_its: int = 30,
              icp_method: str = "p2p", use_old_results: bool = False,
              do_timings: bool = False, override_batch_size=None,
              eval_only_model_to_load=None):
        """Main entry (reference train.py:187-332). Under
        ``use_old_results`` and ``do_timings`` an eval-only run restores no
        checkpoint; ``do_timings`` runs 10 timed evals an epoch at
        ``override_batch_size``."""
        cfg = self.cfg
        setup_logging(self.logdir if self.is_main_process
                      else f"{self.logdir}/proc{self.process_index}")
        train_writer = val_writer = val_writer_180 = None
        if self.is_main_process:
            from alignnet3d_tpu_torch.config import save_config

            configcopy = f"{self.logdir}/config.json"
            if os.path.exists(configcopy):
                datestr = datetime.datetime.today().strftime(
                    "%Y-%m-%d_%H-%M-%S")
                configcopy = f"{configcopy[:-5]}_{datestr}.json"
            save_config(configcopy, cfg)
            train_writer = ScalarWriter(f"{self.logdir}/train/scalars.jsonl")
            val_writer = ScalarWriter(f"{self.logdir}/val/scalars.jsonl")
            val_writer_180 = ScalarWriter(
                f"{self.logdir}/val_180/scalars.jsonl")

        self.init_state()
        start_epoch = 0
        nbpe = self.num_batches_per_epoch
        if eval_only:
            model_dir = eval_only_model_to_load or self.logdir
            if not use_old_results and not do_timings:
                self.restore_checkpoint(
                    os.path.join(model_dir, f"model-{eval_epoch}"))
                if eval_only_model_to_load is None and nbpe and (
                        self.step % nbpe != 0
                        or self.step // nbpe - 1 != int(eval_epoch)):
                    raise ValueError(f"checkpoint step {self.step} is not the "
                                     f"end of epoch {eval_epoch}")
            start_epoch = int(eval_epoch)
            logger.info(f"Evaluating at epoch {start_epoch}")
        else:
            rolling = self._find_checkpoint(
                os.path.join(self.logdir, "model.ckpt"))
            if rolling is not None:
                self.restore_checkpoint(rolling)
                if self.step % nbpe != 0:
                    raise ValueError(f"rolling checkpoint step {self.step} is "
                                     f"not at an epoch end ({nbpe} a epoch)")
                start_epoch = self.step // nbpe
                logger.info(f"Continuing training at epoch {start_epoch}")
            elif cfg.training.pretraining.model != "":
                pre = self.restore_checkpoint(cfg.training.pretraining.model,
                                              except_step=True)
                logger.info(f"Pre-trained weights loaded from {pre} "
                            f"(optimizer count {self.schedule_count}),"
                            " starting initial evaluation")
                self.eval_one_epoch("pretr", eval_only=False,
                                    val_writer=val_writer,
                                    val_writer_180=val_writer_180)
                logger.info("Initial evaluation finished")

        # evaluation.eval_every: the val pass every Nth epoch and always on
        # the last (1, every epoch, is the reference's)
        eval_every = (cfg.evaluation.eval_every
                      if cfg.evaluation.has("eval_every") else 1)
        start = time.time()
        for epoch in range(start_epoch, cfg.training.num_epochs):
            logger.info("**** EPOCH %03d ****" % epoch)
            if not eval_only:
                self.train_one_epoch(epoch, train_writer)
            was_last = epoch == cfg.training.num_epochs - 1
            if do_timings:
                for _ in range(10):
                    self.eval_one_epoch(
                        epoch, eval_only=eval_only, do_timings=True,
                        override_batch_size=override_batch_size)
            elif eval_only or was_last or epoch % eval_every == 0:
                self.eval_one_epoch(
                    epoch, eval_only=eval_only, refine_icp=refine_icp,
                    icp_its=icp_its, icp_method=icp_method,
                    use_old_results=use_old_results, val_writer=val_writer,
                    val_writer_180=val_writer_180)
            if eval_only:
                break
            if epoch % 2 == 0 or was_last:
                self.save_checkpoint("model.ckpt")
            if (epoch % 5 == 0 or was_last
                    or cfg.evaluation.save_every_epoch):
                self.save_checkpoint(f"model-{epoch}")
            elapsed = time.time() - start
            remaining = elapsed / (epoch - start_epoch + 1) * (
                cfg.training.num_epochs - epoch - 1)
            logger.info(
                f"Finished epoch {epoch}."
                f" Time elapsed: {datetime.timedelta(seconds=elapsed)},"
                f" Time remaining: {datetime.timedelta(seconds=remaining)}")
        logger.info("Finished Training")
