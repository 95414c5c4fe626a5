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
  broadcasts rank 0's parameters once when it wraps the model, so every
  replica starts equal.
* ``shard_batch`` / ``batch_sharding`` -> each process's own loader slice
  (``distributed.local_slice``, the native loader's ``process_id``);
  the global batch is the concatenation of the processes' batches and is
  never assembled.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel


def wrap_data_parallel(model: nn.Module) -> DistributedDataParallel:
    """``model`` (on this process's card, or the CPU under gloo) as a
    DistributedDataParallel replica, ready to be captured in a CUDA graph
    (``train/state.make_train_steps``).

    ``broadcast_buffers=False``: the default would copy rank 0's running
    statistics over every rank's at each forward.  They are equal already:
    ``models/layers.BatchNorm`` updates them from the global batch
    statistics on every rank.

    On the card the wrapper is made on a side stream, as PyTorch's rule for
    capturing DDP's whole backward asks (its CUDA graphs notes, "Usage with
    DistributedDataParallel"), and the caller's stream then waits for that
    stream, so rank 0's parameters, broadcast there, are in place before
    any later step or capture.  DDP keeps the parameters' gradient
    accumulators, made on that stream, so every backward accumulates there
    after a wait on the stream that made the gradient; PyTorch warns of
    this at every backward, and the warning is turned off for the process.
    The runtime statistics DDP samples with host reads after its tenth
    iteration are turned off (a sample rate of 2^31 - 1): an iteration
    captured at a sampled count would read back inside the capture.
    """
    dev = next(model.parameters()).device
    if dev.type != 'cuda':
        return DistributedDataParallel(model, broadcast_buffers=False)
    caller = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        ddp = DistributedDataParallel(model, device_ids=[dev.index],
                                      broadcast_buffers=False)
    caller.wait_stream(side)
    torch.autograd.graph.set_warn_on_accumulate_grad_stream_mismatch(False)
    ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
    return ddp
