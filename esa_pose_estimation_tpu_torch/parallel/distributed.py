"""Several processes, one per card: the process group and its helpers
(torch port of the JAX package's ``parallel/distributed.py``).

N processes, each driving its own card, join one ``torch.distributed``
process group: NCCL between CUDA devices, gloo on the CPU.  Each process
streams its own contiguous slice of the records (:func:`local_slice`, the
same arithmetic as the native loader's ``process_id/process_count``
subrange), the model is wrapped by ``parallel/mesh.wrap_data_parallel``,
whose backward averages the gradients, ``models/layers.BatchNorm``
takes its statistics over the global batch, and each step's loss is the
mean over the ranks (:func:`global_mean`), the global batch's, as JAX
logs it.  The steps run as CUDA graphs under several processes too
(``train/state.make_train_steps``): NCCL's collectives are captured with
them, which wants NCCL's asynchronous error handling off from the start
(:func:`prepare_nccl_for_graphs`).

Two JAX pieces have no counterpart.  ``stage_global`` assembles the
processes' batches into one global ``jax.Array``; here there is no global
array: each process keeps its local batch, and the collectives join them.
``compile_aligned`` compiles the sharded step on every process before the
first collective, whose rendezvous has a deadline; eager PyTorch compiles
nothing, and NCCL and gloo set their communicators up inside
:func:`initialize`, which waits for every rank.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist


def requested_processes(num_processes: int | None = None) -> int:
    """The processes a run asks for: ``num_processes``, else
    ``WORLD_SIZE``, else 1.  Known before the group is joined, so that a
    command can check its arguments before any process waits on others."""
    if num_processes is not None:
        return num_processes
    return int(os.environ.get('WORLD_SIZE', '1'))


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: torch.device | str = 'cuda') -> bool:
    """Join the process group (a no-op for one process, and when already
    joined); True if this call joined it.

    Explicit arguments win; otherwise the usual variables apply:
    ``MASTER_ADDR``/``MASTER_PORT`` for the coordinator, ``WORLD_SIZE``
    and ``RANK``.  ``coordinator`` is ``host:port`` (the rank-0 process
    listens there).  The backend is NCCL for a CUDA ``device`` and gloo
    for the CPU; on CUDA the current device becomes card ``LOCAL_RANK``
    (default: the process id modulo the cards in sight).  It returns once
    every process has joined.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    n = requested_processes(num_processes)
    if n <= 1:
        return False
    rank = process_id if process_id is not None else int(env.get('RANK',
                                                                  '-1'))
    if not 0 <= rank < n:
        raise ValueError(f'process_id {rank} outside num_processes {n}')
    if coordinator is None:
        if 'MASTER_ADDR' not in env or 'MASTER_PORT' not in env:
            raise ValueError('several processes need --coordinator host:port '
                             '(or MASTER_ADDR and MASTER_PORT)')
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    device = torch.device(device)
    if device.type == 'cuda':
        local = int(env.get('LOCAL_RANK', rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        prepare_nccl_for_graphs()
    dist.init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo',
        init_method=f'tcp://{coordinator}', world_size=n, rank=rank)
    # no process leaves (and takes the rendezvous down) while another is
    # still connecting
    dist.barrier()
    return True


def prepare_nccl_for_graphs() -> None:
    """NCCL's asynchronous error handling off for the groups made after
    this call: PyTorch captures a collective into a CUDA graph only
    without it (its CUDA graphs notes, "Usage with
    DistributedDataParallel").  A group reads the setting when it is
    made, so this comes before ``init_process_group``."""
    os.environ['TORCH_NCCL_ASYNC_ERROR_HANDLING'] = '0'


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``, the whole group by
    default (``x`` itself without one): a sum by one ``all_reduce`` of a
    copy, then a division by the group's size, so a one-rank group gives
    ``x``'s bits.  A step's loss through it is the global batch's loss
    when every rank's batch has the same size (the mean of equal-sized
    means); under a ``model`` axis ``group`` is the data axis's, whose
    ranks hold the batch's slices.  It draws nothing and reads nothing
    back: a captured step holds the collective."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out.div_(dist.get_world_size(group))


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The processes in the group (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_slice(records: Sequence, process_id: int | None = None,
                process_count: int | None = None) -> Sequence:
    """Process ``process_id``'s contiguous slice of ``records``, balanced to
    within one record (the native loader's subrange arithmetic, so the two
    ingest paths partition identically)."""
    pid = rank() if process_id is None else process_id
    n_proc = world_size() if process_count is None else process_count
    if not 0 <= pid < n_proc:
        raise ValueError(f'process_id {pid} outside process_count {n_proc}')
    n = len(records)
    return records[n * pid // n_proc: n * (pid + 1) // n_proc]


def barrier() -> None:
    """Wait until every process gets here (a no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


def is_primary() -> bool:
    """True on the process that owns the logs and checkpoints."""
    return rank() == 0


def global_batch_size(per_process_batch: int) -> int:
    return per_process_batch * world_size()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
