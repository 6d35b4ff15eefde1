"""The data-parallel width and its equal share per process.

Counterpart of the selection rules of ``alignnet3d_tpu/parallel/mesh.py``
(``choose_dp``, ``balanced_process_devices``), with the JAX package's
assert texts. Here every process owns one card, so the data-parallel width
is the number of processes and each process holds ``batch_size /
processes`` rows of every batch. The 'mp' axis (tensor parallelism of the
wide layers) is TPU-only and not ported (ROADMAP.md, ground rules);
``leaf_pspec`` and ``state_shardings`` have no counterpart, since every
process holds the whole model.
"""

from __future__ import annotations

from typing import Any


def choose_dp(dp: int, batch_size: int, num_processes: int = 1) -> int:
    """Largest dp' <= dp that divides ``batch_size`` and, with several
    processes, is also a multiple of ``num_processes``, so every process
    owns the same number of dp rows. ``num_processes`` is always a valid
    floor, since the batch must divide over the processes."""
    if num_processes > 1:
        assert batch_size % num_processes == 0, (
            f"batch_size {batch_size} must divide over "
            f"{num_processes} processes"
        )
        while dp > num_processes and (
            batch_size % dp != 0 or dp % num_processes != 0
        ):
            dp -= 1
    else:
        while dp > 1 and batch_size % dp != 0:
            dp -= 1
    return dp


def balanced_process_devices(devices, dp: int, mp: int,
                             num_processes: int) -> list:
    """Pick ``dp*mp`` devices with an EQUAL share from every process
    (grouped by ``device.process_index``, taken in process order, so
    consecutive ``mp`` blocks stay within a process)."""
    mp = max(1, mp)
    per_proc = dp * mp // num_processes
    assert per_proc % mp == 0, (
        f"mp={mp} groups must not straddle processes "
        f"(dp={dp}, processes={num_processes})"
    )
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    assert all(len(v) >= per_proc for v in by_proc.values()), (
        f"mesh {dp}x{mp} needs {per_proc} devices per process; "
        f"have {[len(v) for v in by_proc.values()]}"
    )
    return [d for p in sorted(by_proc) for d in by_proc[p][:per_proc]]


def data_parallel_width(cfg: Any, batch_size: int, num_processes: int) -> int:
    """The number of processes a batch is split over: one card each. A
    config asking for tensor parallelism (``tpu.mesh.mp > 1``) raises."""
    mesh = cfg.tpu.mesh if cfg.has("tpu") and cfg.tpu.has("mesh") else None
    if mesh is not None and mesh.has("mp") and mesh.mp > 1:
        raise NotImplementedError(
            "tpu.mesh.mp > 1 (tensor parallelism) is TPU-only and not "
            "ported (ROADMAP.md, ground rules)")
    return choose_dp(num_processes, batch_size, num_processes)
