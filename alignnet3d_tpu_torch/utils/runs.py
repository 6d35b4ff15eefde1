"""Run-directory helpers shared by the probe/eval scripts.

Counterpart of ``alignnet3d_tpu/utils/runs.py``. A run's saved
``config.json`` derives its logdir from the config FILENAME stem
("config" -> runs/config/), so scripts that accept "a run dir or a config
path" must restore checkpoints from the config's own directory when the
snapshot lives there.

The port writes ``model-<epoch>.pt`` and reads that or the JAX package's
flax ``model-<epoch>.msgpack`` (``checkpoint.find``: a path without a
suffix restores ``.pt`` if it exists, else ``.msgpack``), so a snapshot
next to the config is either file, found by ``checkpoint.find``; the JAX
package's copy looks for the ``.msgpack`` only.
"""

from __future__ import annotations

import os

from alignnet3d_tpu_torch.checkpoint import find


def resolve_run_checkpoint(cfg_path: str, epoch) -> tuple[str, str | None]:
    """(config path, checkpoint-dir-or-None) for a run dir or config.

    Returns the config.json path (resolving a directory argument to the
    config inside it) and the directory containing ``model-<epoch>.pt``
    or ``model-<epoch>.msgpack`` if the checkpoint sits next to the config
    — None means "derive the checkpoint dir from the config's logdir as
    usual".
    """
    if os.path.isdir(cfg_path):
        cfg_path = os.path.join(cfg_path, "config.json")
    ckpt_dir = os.path.dirname(os.path.abspath(cfg_path))
    if find(os.path.join(ckpt_dir, f"model-{epoch}")) is None:
        ckpt_dir = None
    return cfg_path, ckpt_dir
