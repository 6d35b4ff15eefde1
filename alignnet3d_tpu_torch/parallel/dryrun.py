"""Run the CLI as N data-parallel processes on one machine.

Counterpart of ``__graft_entry__.dryrun_multihost`` and
``scripts/multihost_worker.py``: ``dryrun_multihost(n_proc)`` generates a
tiny dataset and runs one real ``Trainer`` epoch through the CLI in
``n_proc`` local processes (gloo on the CPU), then checks process 0's
artifacts. ``run_workers`` starts the processes of any CLI command, each
with the three ``ALIGNNET_*`` variables a user sets, running this module:

    ALIGNNET_COORDINATOR=file:///tmp/rdzv ALIGNNET_NUM_PROCS=P \\
    ALIGNNET_PROC_ID=I python -m alignnet3d_tpu_torch.parallel.dryrun \\
        [--backend gloo] -- train --config C.json --device cpu

A worker joins the process group (``multihost.maybe_initialize``), runs
``cli.main`` on the arguments after ``--``, and prints one JSON line: its
rank, the process group's backend, a SHA-256 of its parameters and the
launch counts of the six kernel wrappers. The rendezvous is passed explicitly (a ``file://`` path is
private to its caller), so runs in parallel never share a port.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULT_TAG = "dryrun worker result: "


def file_rendezvous(directory: str) -> str:
    """A fresh ``file://`` rendezvous under ``directory``."""
    return f"file://{os.path.join(directory, 'rdzv_' + uuid.uuid4().hex)}"


def run_workers(n_proc: int, cli_args: list[str], coordinator: str,
                backend: str | None = None,
                timeout: float = 900.0) -> list[dict]:
    """Run ``cli_args`` through the CLI in ``n_proc`` processes joined at
    ``coordinator``; returns each worker's result line (as a dict, with
    its output under ``"output"``), in rank order. Raises when a worker
    fails or the run outlasts ``timeout`` seconds (every worker is killed)."""
    from alignnet3d_tpu_torch.parallel import multihost

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update({multihost.ENV_COORDINATOR: coordinator,
                multihost.ENV_NUM_PROCS: str(n_proc)})
    cmd = [sys.executable, "-m", "alignnet3d_tpu_torch.parallel.dryrun"]
    if backend is not None:
        cmd += ["--backend", backend]
    procs = []
    for rank in range(n_proc):
        procs.append(subprocess.Popen(
            cmd + ["--"] + list(cli_args), cwd=REPO,
            env={**env, multihost.ENV_PROC_ID: str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # drain every pipe at once: a worker blocked on a full pipe inside a
    # collective would stall the others
    outs = [""] * n_proc

    def drain(i, p):
        outs[i] = p.communicate()[0]

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.time()))
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"dryrun workers timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(10)
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dryrun worker {rank} failed "
                               f"(rc={p.returncode}):\n{out[-8000:]}")
        results.append({**json.loads(lines[-1][len(RESULT_TAG):]),
                        "output": out})
    return results


def kernel_launches() -> dict:
    """The launch counts of the six kernel wrappers in this process."""
    from alignnet3d_tpu_torch.icp.p2point import icp_update
    from alignnet3d_tpu_torch.ops.edge_conv_kernels import fused_edge_stage
    from alignnet3d_tpu_torch.ops.edge_train_kernels import (
        fused_edge_stage_train,
    )
    from alignnet3d_tpu_torch.ops.knn_kernels import knn_points
    from alignnet3d_tpu_torch.ops.nn_kernels import nn_argmin
    from alignnet3d_tpu_torch.ops.pointnet_kernels import fused_pointnet

    return {f.__name__: f.launches for f in (
        fused_pointnet, nn_argmin, knn_points, fused_edge_stage,
        fused_edge_stage_train, icp_update)}


def params_digest(model) -> str:
    """SHA-256 of a model's parameters and buffers, in state_dict order."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dryrun_multihost(n_proc: int = 2) -> None:
    """One Trainer epoch (training, eval, process-0 artifacts) in
    ``n_proc`` CPU processes on a tiny generated dataset."""
    from alignnet3d_tpu_torch.data.synthetic import generate_dataset

    root = tempfile.mkdtemp(prefix="alignnet_torch_mh_")
    try:
        base = os.path.join(root, "data")
        generate_dataset(base, num_train=32, num_val=8, seed=3, vres=16,
                         hres=180)
        cfg = {
            "data": {"basepath": base},
            "logging": {"basedir": os.path.join(root, "runs")},
            "model": {
                "num_points": 32, "backbone": "pointnet",
                "options": {
                    "angle_factor": 1.0, "early_stage_factor": 0.5,
                    "s1transformer": [[16, 32], [[32], 0.7]],
                    "s2transformer": [[16, 32], [[32], 0.7]],
                    "embedding": [16, 64],
                    "remaining_transform_prediction": [[32], 0.7],
                },
                "angles": {"num_bins": 8, "accept_inverted_angle": True},
            },
            "training": {"batch_size": 8, "num_epochs": 1,
                         "learning_rate": 0.005},
            "evaluation": {"save_every_epoch": True},
        }
        cfg_path = os.path.join(root, "MH.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        results = run_workers(
            n_proc, ["train", "--config", cfg_path, "--device", "cpu"],
            file_rendezvous(root), backend="gloo")
        assert len({r["params"] for r in results}) == 1, \
            "the processes ended with different parameters"
        logdir = os.path.join(root, "runs", "MH")
        assert os.path.isfile(os.path.join(logdir, "model.ckpt.pt"))
        with open(os.path.join(logdir, "val", "eval000000",
                               "eval.json")) as f:
            ev = json.load(f)
        assert ev["num"] == 8
        print(f"dryrun_multihost ok: {n_proc} processes, eval num="
              f"{ev['num']}, corr_levels={ev['corr_levels']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m alignnet3d_tpu_torch.parallel.dryrun")
    parser.add_argument("--backend", default=None,
                        help="nccl or gloo (default: nccl with a card)")
    parser.add_argument("cli_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cli_args = args.cli_args[1:] if args.cli_args[:1] == ["--"] \
        else args.cli_args

    import torch
    import torch.distributed as dist

    from alignnet3d_tpu_torch import cli
    from alignnet3d_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    if not multihost.maybe_initialize(backend=args.backend):
        raise RuntimeError(f"no process group: {multihost.ENV_COORDINATOR} "
                           f"is not set")
    try:
        trainer = cli.main(cli_args)
        result = {"rank": multihost.process_index(),
                  "backend": dist.get_backend(),
                  "params": params_digest(trainer.model),
                  "launches": kernel_launches()}
        print(RESULT_TAG + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
