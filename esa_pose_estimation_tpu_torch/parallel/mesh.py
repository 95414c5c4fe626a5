"""Data parallelism over the processes of the group (the counterpart of the
JAX package's ``parallel/mesh.py``).

JAX shards the batch over the ``data`` axis of a device mesh and lets
GSPMD insert the all-reduces.  Here each process drives one card and holds
a full replica; ``torch.nn.parallel.DistributedDataParallel`` averages the
gradients in its backward.  What replaces each JAX piece:

* ``make_mesh`` -> the process group of ``parallel/distributed.initialize``
  (one rank per card); the ``model`` axis (tensor parallelism of the head
  convs) has no counterpart: every rank holds the whole model.
* ``shard_state`` / ``replicate`` -> :func:`wrap_data_parallel`, which
  broadcasts rank 0's parameters and buffers once when it wraps the
  model, so every replica starts equal.
* ``shard_batch`` / ``batch_sharding`` -> each process's own loader slice
  (``distributed.local_slice``, the native loader's ``process_id``);
  the global batch is the concatenation of the processes' batches and is
  never assembled.
"""

from __future__ import annotations

from torch import nn
from torch.nn.parallel import DistributedDataParallel


def wrap_data_parallel(model: nn.Module) -> DistributedDataParallel:
    """``model`` (on this process's card, or the CPU under gloo) as a
    DistributedDataParallel replica.

    ``broadcast_buffers=False``: the default would copy rank 0's running
    statistics over every rank's at each forward.  They are equal already:
    ``models/layers.BatchNorm`` updates them from the global batch
    statistics on every rank.
    """
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == 'cuda' else None,
        broadcast_buffers=False)
