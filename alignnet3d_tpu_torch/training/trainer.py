"""The train/eval loop: the port of ``alignnet3d_tpu/training/trainer.py``
(reference train.py:187-545).

What it keeps from the reference and the JAX package:
- staircase LR decay with a 1e-5 floor, Adam or momentum SGD, the LR read
  at the step count before the update (as optax's schedule);
- the scheduled BN momentum fed into every ``EmaBatchNorm`` each step;
- per epoch a shuffled drop-remainder training epoch, then a full val-set
  eval writing eval.json + eval_180.json and the 8 pred_*.npy arrays;
- checkpoints: rolling ``model.ckpt`` every 2 epochs, numbered
  ``model-<E>`` every 5 (or every epoch with evaluation.save_every_epoch)
  and on the last; resume from the rolling one with the epoch-alignment
  assert; ``training.pretraining.model`` restores all but the step and
  runs an eval tagged 'pretr';
- JSONL scalar files train/val/val_180 with the reference's tags.

In PyTorch: checkpoints are ``torch.save`` dicts of the step, the model's
``state_dict`` and the optimizer's, named as the JAX package's with
``.pt`` for ``.msgpack``. The input jitter (sigma 0.01, clipped at 0.05)
is drawn on the device from a ``torch.Generator`` seeded from ``seed``,
and dropout from another. Batches come from the ``PackedDataset`` numpy
path behind a background prefetch thread; the per-step scalars stay on
the device until one readback at the end of the epoch.

Options the port does not run raise ``NotImplementedError`` naming their
ROADMAP item; the mesh and ``tpu.steps_per_dispatch`` are TPU-only and
have no counterpart here.
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

from alignnet3d_tpu_torch.data import provider
from alignnet3d_tpu_torch.evaluation import metrics as evaluation
from alignnet3d_tpu_torch.evaluation.decode import decode_pair_outputs
from alignnet3d_tpu_torch.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu_torch.models.backbones import Dropout
from alignnet3d_tpu_torch.models.losses import LossSpec, get_loss
from alignnet3d_tpu_torch.training import schedules
from alignnet3d_tpu_torch.weights import init_state_dict

logger = logging.getLogger("alignnet3d_tpu_torch")

_ROADMAP = "ROADMAP.md, Queue 1"


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


def _check_ported(cfg):
    """Raise on the options this port does not run yet."""
    unported = []
    if cfg.data.has("denoise"):
        unported.append("data.denoise")
    if cfg.data.has("resample") and cfg.data.resample.mode == "voxel":
        unported.append("data.resample")
    if cfg.data.has("residual_task") and cfg.data.residual_task.enabled:
        unported.append("data.residual_task")
    ev = cfg.evaluation
    if ev.has("network_refine") and ev.network_refine.enabled:
        unported.append("evaluation.network_refine")
    if ev.has("special"):
        unported.append("evaluation.special")
    if cfg.has("tpu") and cfg.tpu.has("profile"):
        unported.append("tpu.profile")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported yet ({_ROADMAP})")


class Trainer:
    """``Trainer(cfg, seed, device=...).train()``. ``device`` is required:
    ``"cuda"`` trains on the card through its kernels, ``"cpu"`` runs the
    kernels' plain twins."""

    def __init__(self, cfg: Any, seed: int = 0, *,
                 device: torch.device | str):
        _check_ported(cfg)
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.spec = ModelSpec.from_config(cfg)
        self.loss_spec = LossSpec.from_config(cfg)
        self.model = AlignNet(self.spec).to(self.device)
        self.logdir = cfg.logging.logdir
        self.batch_size = cfg.training.batch_size
        self.train_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/train.txt")
        self.val_indices = provider.getDataFiles(
            f"{cfg.data.basepath}/split/val.txt")
        self.num_batches_per_epoch = len(self.train_indices) // self.batch_size
        self.dataset = provider.PackedDataset(cfg.data.basepath)
        self._data_rng = np.random.default_rng(seed + 1)
        self._jitter_gen = torch.Generator(self.device).manual_seed(seed + 2)
        dropout_gen = torch.Generator(self.device).manual_seed(seed + 3)
        for module in self.model.modules():
            if isinstance(module, Dropout):
                module.generator = dropout_gen
        self.optimizer = None
        self.step = 0

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

    # ---------------------------------------------------------- the steps

    def _to_device(self, batch):
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
                     for a in batch)

    def _jitter(self, pcs: torch.Tensor) -> torch.Tensor:
        """Per-point gaussian jitter, sigma 0.01 clipped at 0.05 (reference
        provider.py:60-71), drawn on the device."""
        noise = torch.randn(pcs.shape, generator=self._jitter_gen,
                            device=self.device)
        return pcs + torch.clamp(0.01 * noise, -0.05, 0.05)

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch; returns its scalars, the
        losses as device tensors."""
        pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = \
            self._to_device(batch)
        bn_m = schedules.bn_decay(self.step, self.cfg, self._nbpe)
        lr = schedules.learning_rate(self.step, self.cfg, self._nbpe)
        pcs1, pcs2 = self._jitter(pcs1), self._jitter(pcs2)
        self.model.train()
        out = self.model(pcs1, pcs2, momentum=bn_m)
        loss, aux = get_loss(pcs1, pcs2, translations, rel_angles, c1, c2,
                             a1, a2, out, spec=self.loss_spec)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return {"losses/loss": loss.detach(),
                "hyperparameters/learning_rate": lr,
                "hyperparameters/bn_decay": bn_m,
                **{k: v.detach() for k, v in aux.items()}}

    @torch.no_grad()
    def eval_step(self, batch):
        """(loss, end_points as numpy) of the eval-mode model."""
        pcs1, pcs2, translations, rel_angles, c1, c2, a1, a2 = \
            self._to_device(batch)
        self.model.eval()
        out = self.model(pcs1, pcs2)
        loss, _ = get_loss(pcs1, pcs2, translations, rel_angles, c1, c2, a1,
                           a2, out, spec=self.loss_spec)
        return float(loss), {k: v.cpu().numpy() for k, v in out.items()}

    # -------------------------------------------------------- checkpoints

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}.pt")

    def save_checkpoint(self, name: str) -> str:
        path = self._ckpt_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict()}, path)
        logger.info(f"Model saved in file: {path}")
        return path

    def restore_checkpoint(self, path: str, except_step: bool = False):
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        if not except_step:
            self.step = int(ckpt["step"])

    # ------------------------------------------------------------- epochs

    def _make_batch(self, indices, rng: np.random.Generator | None = None):
        rng = self._data_rng if rng is None else rng
        return self.dataset.sample_batch(indices, self.spec.num_points, rng)

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
        a guard that stops the run on a non-finite loss."""
        epoch_rng = self._epoch_rng(1, epoch)
        idxs = np.asarray(self.train_indices).copy()
        epoch_rng.shuffle(idxs)
        num_batches = len(idxs) // self.batch_size
        bs = self.batch_size
        prefetch = (self.cfg.tpu.prefetch_batches if self.cfg.has("tpu")
                    else 2)

        def make(i):
            return self._make_batch(idxs[i * bs:(i + 1) * bs], rng=epoch_rng)

        step_metrics = []
        for batch in progress(
                provider.PrefetchIterator(make, num_batches, prefetch),
                desc=f"train epoch {epoch}", total=num_batches):
            step_metrics.append(self.train_step(batch))
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
        writer.write_rows(range(self.step - num_batches + 1, self.step + 1),
                          stacked)
        logger.info("train mean loss: %f"
                    % (float(loss_vals.sum()) / num_batches))

    def eval_one_epoch(self, epoch, eval_only: bool,
                       val_writer: ScalarWriter | None = None,
                       val_writer_180: ScalarWriter | None = None) -> float:
        """Network-only eval of the full val set, both eval files and the
        prediction arrays (reference train.py:386-545)."""
        cfg = self.cfg
        batch_size = self.batch_size
        val_idxs = list(self.val_indices)
        n_val = len(val_idxs)
        num_batches = int(np.ceil(n_val / batch_size))
        num_full_batches = n_val // batch_size
        # one fixed stream: a checkpoint gives the same predictions in any
        # eval, and val curves carry no resampling noise
        eval_rng = self._epoch_rng(2)
        eval_dir = f"{self.logdir}/val/eval{str(epoch).zfill(6)}"
        if os.path.isdir(eval_dir):
            backup = f"{eval_dir}_backup_{int(time.time())}"
            k = 0
            while os.path.exists(backup):
                k += 1
                backup = f"{eval_dir}_backup_{int(time.time())}_{k}"
            os.rename(eval_dir, backup)
        os.makedirs(eval_dir, exist_ok=True)

        P = {k: np.empty((n_val, d), dtype=np.float32) for k, d in [
            ("pred_translations", 3), ("pred_angles", 1),
            ("pred_s1_pc1centers", 3), ("pred_s1_pc2centers", 3),
            ("pred_s2_pc1centers", 3), ("pred_s2_pc2centers", 3),
            ("pred_s2_pc1angles", 1), ("pred_s2_pc2angles", 1)]}
        G = {"gt_translations": np.empty((n_val, 3), np.float32),
             "gt_angles": np.empty((n_val, 1), np.float32),
             "gt_pc1centers": np.empty((n_val, 3), np.float32)}
        nb = self.spec.num_bins
        # the reference decodes the residuals unscaled (tp8.py:241-244);
        # evaluation.scale_residuals opts into the consistent decode
        residual_scale = (np.pi / nb if cfg.evaluation.has("scale_residuals")
                          and cfg.evaluation.scale_residuals else 1.0)
        resolve_flips = bool(cfg.evaluation.has("resolve_flips")
                             and cfg.evaluation.resolve_flips)
        loss_sum, cumulated_times = 0.0, 0.0
        for batch_idx in progress(range(num_batches),
                                  desc=f"eval epoch {epoch}",
                                  total=num_batches):
            start = batch_idx * batch_size
            end = min(start + batch_size, n_val)
            actual = end - start
            # pad to a full batch (the reference feeds a stale tail)
            padded = val_idxs[start:end] + [val_idxs[0]] * (batch_size - actual)
            batch = self._make_batch(padded, rng=eval_rng)
            t0 = time.time()
            loss_val, out = self.eval_step(batch)
            cumulated_times += time.time() - t0
            if actual == batch_size:
                loss_sum += loss_val
            t0 = time.time()
            dec = decode_pair_outputs(out, batch[0], batch[1], nb,
                                      residual_scale,
                                      resolve_flips=resolve_flips, n=actual,
                                      device=self.device)
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

        mean_loss = loss_sum / num_full_batches if num_full_batches else 0.0
        mean_time = cumulated_times / float(n_val)
        metas = self.dataset.metas(val_idxs)
        for accept_inverted, writer in ((False, val_writer),
                                        (True, val_writer_180)):
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
              refine_icp: bool = False, use_old_results: bool = False,
              do_timings: bool = False, eval_only_model_to_load=None):
        """Main entry (reference train.py:187-332)."""
        for flag, name in ((refine_icp, "refine_icp (ICP in eval)"),
                           (use_old_results, "use_old_results"),
                           (do_timings, "do_timings")):
            if flag:
                raise NotImplementedError(f"{name}: not ported yet "
                                          f"({_ROADMAP})")
        cfg = self.cfg
        setup_logging(self.logdir)
        from alignnet3d_tpu_torch.config import save_config

        configcopy = f"{self.logdir}/config.json"
        if os.path.exists(configcopy):
            datestr = datetime.datetime.today().strftime("%Y-%m-%d_%H-%M-%S")
            configcopy = f"{configcopy[:-5]}_{datestr}.json"
        save_config(configcopy, cfg)

        train_writer = ScalarWriter(f"{self.logdir}/train/scalars.jsonl")
        val_writer = ScalarWriter(f"{self.logdir}/val/scalars.jsonl")
        val_writer_180 = ScalarWriter(f"{self.logdir}/val_180/scalars.jsonl")

        self.init_state()
        start_epoch = 0
        nbpe = self.num_batches_per_epoch
        if eval_only:
            model_dir = eval_only_model_to_load or self.logdir
            path = os.path.join(model_dir, f"model-{eval_epoch}.pt")
            self.restore_checkpoint(path)
            if eval_only_model_to_load is None and nbpe:
                if (self.step % nbpe != 0
                        or self.step // nbpe - 1 != int(eval_epoch)):
                    raise ValueError(f"checkpoint step {self.step} is not the "
                                     f"end of epoch {eval_epoch}")
            start_epoch = int(eval_epoch)
            logger.info(f"Evaluating at epoch {start_epoch}")
        else:
            rolling = self._ckpt_path("model.ckpt")
            if os.path.isfile(rolling):
                self.restore_checkpoint(rolling)
                if self.step % nbpe != 0:
                    raise ValueError(f"rolling checkpoint step {self.step} is "
                                     f"not at an epoch end ({nbpe} a epoch)")
                start_epoch = self.step // nbpe
                logger.info(f"Continuing training at epoch {start_epoch}")
            elif cfg.training.pretraining.model != "":
                pre = cfg.training.pretraining.model
                if not pre.endswith(".pt"):
                    pre = pre + ".pt"
                self.restore_checkpoint(pre, except_step=True)
                logger.info(f"Pre-trained weights loaded from {pre},"
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
            if eval_only or was_last or epoch % eval_every == 0:
                self.eval_one_epoch(epoch, eval_only=eval_only,
                                    val_writer=val_writer,
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
