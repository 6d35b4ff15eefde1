"""Multi-process data parallelism with ``torch.distributed``: one process a
card.

Counterpart of ``alignnet3d_tpu/parallel/multihost.py``. The JAX package
runs one ``jit`` over a ('dp', 'mp') mesh, where every reduction over the
batch axis is a reduction over the GLOBAL batch. Here each process holds
its own rows of every batch (its "local batch"), and the reductions that
must be global say so:

- ``all_reduce_sum``: a sum over the processes whose backward sums the
  cotangents over the processes too. Every process then computes the same
  global value (batch-norm statistics, the loss), and the gradient each
  process gets is the one of the sum of all processes' copies, so
  ``DistributedDataParallel``'s mean over processes is the exact gradient;
- ``all_reduce_``: the same sum, in place and outside autograd (the fused
  edge stage's per-pass sums, whose backward is written by hand);
- ``all_gather_rows``: the processes' rows of an eval batch, in process
  order (the JAX package's replicated ``out_shardings``).

The JAX package's ``global_batch`` has no counterpart: the local batch
stays in its process, and nothing assembles the global one.

Activation: set ``ALIGNNET_COORDINATOR`` (``host:port``, or a
``tcp://`` or ``file://`` rendezvous), ``ALIGNNET_NUM_PROCS`` (the
number of processes) and ``ALIGNNET_PROC_ID`` (this one's rank) in every
process's environment, or pass them to ``maybe_initialize``, then run the
normal CLI. Process ``i`` owns the card ``cuda:{i % device_count}``.
Without the variables everything runs as one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

ENV_COORDINATOR = "ALIGNNET_COORDINATOR"
ENV_NUM_PROCS = "ALIGNNET_NUM_PROCS"
ENV_PROC_ID = "ALIGNNET_PROC_ID"


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group from the arguments or the environment.

    Returns True when running multi-process (after joining; also when the
    group already exists), False when no coordinator is given. ``backend``
    defaults to NCCL when the process sees a card and gloo otherwise; gloo
    also moves CUDA tensors (two processes on one card, where NCCL refuses).
    With a card, this process's card becomes the current device."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ[ENV_NUM_PROCS])
    if process_id is None:
        process_id = int(os.environ[ENV_PROC_ID])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def local_device(device: torch.device | str) -> torch.device:
    """``device`` with a bare ``cuda`` made this process's card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", process_index()
                            % torch.cuda.device_count())
    return device


def main_isfile(path: str) -> bool:
    """Process 0's ``os.path.isfile``, broadcast to every process: without
    a shared file system the processes' own answers can differ, and a resume
    decided differently deadlocks in the next collective."""
    if process_count() <= 1:
        return os.path.isfile(path)
    return bool(broadcast_tree(os.path.isfile(path) if is_main() else None))


def broadcast_tree(tree):
    """Process 0's ``tree`` (any picklable object; its tensors arrive on
    the CPU) on every process; the argument is ignored elsewhere. Used so
    that only process 0 needs checkpoint bytes on disk."""
    if process_count() <= 1:
        return tree
    box = [_to_cpu(tree) if is_main() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _to_cpu(tree):
    """``tree`` with every tensor in it moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes in place (no autograd); returns it."""
    if process_count() > 1:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable: the backward
    sums the cotangents over the processes. ``x`` itself with one."""
    return _AllReduceSum.apply(x) if process_count() > 1 else x


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (the same shape on each), concatenated along
    the first axis in process order. ``t`` itself with one process."""
    if process_count() <= 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This process's rows of a batch of ``total`` rows over all
    processes: ``local`` rows from ``lo``. A tensor whose first axis holds
    k blocks of ``local`` rows (the Siamese encoder stacks both views'
    batches) is k blocks of ``total`` rows globally."""

    lo: int
    local: int
    total: int

    def take(self, draw: Callable[[tuple], torch.Tensor],
             shape) -> torch.Tensor:
        """``draw`` the random tensor of the global batch's shape and keep
        this process's rows of it: every process draws from the same
        generator, so the processes together draw what one process does on
        the global batch."""
        blocks = shape[0] // self.local
        full = draw((blocks * self.total, *shape[1:]))
        rows = (torch.arange(blocks)[:, None] * self.total + self.lo
                + torch.arange(self.local)[None, :]).reshape(-1)
        return full[rows.to(full.device)]
