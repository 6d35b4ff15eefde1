"""Command line of the port, flag-compatible with ``alignnet3d_tpu/cli.py``
(reference train.py:32-40), plus ``--device``:

    python -m alignnet3d_tpu_torch.cli {train,eval_only} --config C.json
        [--refineICP] [--its N] [--use_old_results]
        [--refineICPmethod p2p|p2plane] [--eval_epoch E] [--seed S]
        [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given. With the
``ALIGNNET_COORDINATOR``, ``ALIGNNET_NUM_PROCS`` and ``ALIGNNET_PROC_ID``
variables set, it first joins the other processes of a data-parallel run
(``parallel/multihost.py``), and ``--device cuda`` means this process's
card. Of the special
evaluation modes (``evaluation.special.mode``, reference train.py:548-561)
'icp' runs the standalone classical baselines (``icp/runner.py``),
'timings' 10 timed evals at batch 32, and 'held' the velocity-only eval of
Held-style tracking data with the model of ``evaluation.special.held.model``
(a run directory; its ``model-<eval_epoch>`` checkpoint, ``.pt`` or
``.msgpack``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m alignnet3d_tpu_torch.cli")
    parser.add_argument("operation", choices=["train", "eval_only"],
                        help="Operation to run")
    parser.add_argument("--config", required=True, help="Config file")
    parser.add_argument("--refineICP", action="store_true",
                        help="Refine results with ICP")
    parser.add_argument("--its", required=False, default=30,
                        help="ICP refinement iterations")
    parser.add_argument("--use_old_results", action="store_true",
                        help="Reuse stored predictions instead of inference")
    parser.add_argument("--refineICPmethod", required=False, default="p2p",
                        choices=["p2p", "p2plane"],
                        help="ICP method for refinement")
    parser.add_argument("--eval_epoch", required=False, default="199",
                        help="Epoch to eval in eval_only mode")
    parser.add_argument("--seed", required=False, default=0, type=int)
    parser.add_argument("--device", required=False, default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    return parser


def main(argv=None):
    """Run the command; returns the last ``Trainer``, or in 'icp' mode the
    runner's eval dict."""
    flags = build_parser().parse_args(argv)

    # a data-parallel run: join the other processes (no-op without the
    # ALIGNNET_* variables) before anything touches a device
    from alignnet3d_tpu_torch.parallel import multihost

    multihost.maybe_initialize()

    from alignnet3d_tpu_torch.config import load_config
    from alignnet3d_tpu_torch.training.trainer import Trainer

    cfg = load_config(flags.config)
    if cfg.evaluation.has("special"):
        mode = cfg.evaluation.special.mode
        if mode == "icp":
            print(flags.config)
            from alignnet3d_tpu_torch.icp import runner

            return runner.evaluate(cfg, flags.use_old_results,
                                   device=flags.device)
        if mode == "timings":
            for bs in [32]:
                cfg.training.__dict__["batch_size"] = bs
                trainer = Trainer(cfg, seed=flags.seed, device=flags.device)
                trainer.train(eval_only=True, eval_epoch=flags.eval_epoch,
                              do_timings=True, override_batch_size=bs)
            return trainer
        if mode == "held":
            trainer = Trainer(cfg, seed=flags.seed, device=flags.device)
            trainer.train(eval_only=True, eval_epoch=flags.eval_epoch,
                          eval_only_model_to_load=cfg.evaluation.special.held
                          .model)
            return trainer
        raise ValueError(f"unknown special mode {mode!r}")

    trainer = Trainer(cfg, seed=flags.seed, device=flags.device)
    if flags.operation == "train":
        trainer.train()
    else:
        trainer.train(eval_only=True, eval_epoch=flags.eval_epoch,
                      refine_icp=flags.refineICP, icp_its=int(flags.its),
                      icp_method=flags.refineICPmethod,
                      use_old_results=flags.use_old_results)
    return trainer


if __name__ == "__main__":
    main()
