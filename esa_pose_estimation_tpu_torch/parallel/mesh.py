"""Data parallelism: the counterpart of the JAX package's
``parallel/mesh.py``.

JAX shards a batch over the ``data`` axis of a device mesh and compiles
one program for all the devices.  The port has two counterparts:

* **One process, several cards** (serving and evaluation):
  :func:`make_mesh` lists the cards of the ``data`` axis (:class:`Mesh`),
  :func:`batch_sharding` and :func:`shard_batch` cut a batch into
  contiguous slices of its leading axis in device order, as
  ``P('data')`` lays them out, and copy each slice to its card
  (:class:`Sharded`), and :func:`replicate` puts one copy of a module on
  each card.  ``pipeline.make_sharded_pipeline`` and
  ``train/state.make_sharded_eval_step`` run one program per card on
  them.
* **One process per card** (training): the process group of
  ``parallel/distributed.initialize``; :func:`wrap_data_parallel`
  broadcasts rank 0's parameters once, so every replica starts equal, and
  DistributedDataParallel averages the gradients in its backward.  Each
  process reads its own slice of the global batch
  (``distributed.local_slice``, the native loader's ``process_id``); the
  global batch is never assembled.

The ``model`` axis (output-channel tensor parallelism of the head convs,
JAX's ``param_sharding`` and ``shard_state``) has no counterpart yet:
:func:`make_mesh` refuses ``n_model > 1`` (ROADMAP.md section 1, item 1).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Sequence

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from esa_pose_estimation_tpu_torch.utils.graphs import tensors_of, tree_map

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


class Mesh(NamedTuple):
    """The cards of the ``data`` axis, in shard order (shard k of a batch
    lies on ``devices[k]``).  The ``model`` axis has extent 1."""
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A (data, model) mesh over every visible card, or over ``devices``.

    As in JAX, the factorization must use every given device (an idle
    card reads as a throughput regression), so ``n_data * n_model`` must
    equal the number of devices, with JAX's errors.  ``n_model > 1`` has
    no counterpart yet and raises.

    ``devices`` may repeat a device: torch has one CPU device, so a CPU
    mesh of n shards is ``[torch.device('cpu')] * n``, and one card can
    hold several shards, each with its own replica and program.  A mesh
    is all CUDA or all CPU; without ``devices`` and without a card it
    raises.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device is visible; pass '
                               "devices=[torch.device('cpu')] * n for a CPU "
                               'mesh')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f'make_mesh: mixed device types {devices}')
    devices = [torch.device('cuda', torch.cuda.current_device())
               if d.type == 'cuda' and d.index is None else d
               for d in devices]
    if n_model < 1 or n_model > len(devices):
        raise ValueError(f'n_model={n_model} with {len(devices)} devices')
    if n_data is None:
        if len(devices) % n_model:
            raise ValueError(
                f'{len(devices)} devices do not factor into n_model='
                f'{n_model} (pass n_data or a device subset explicitly)')
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(f'mesh {n_data}x{n_model} uses '
                         f'{n_data * n_model} of {len(devices)} devices; '
                         f'pass devices=... to use a subset deliberately')
    if n_model > 1:
        raise NotImplementedError(
            f'n_model={n_model}: the model axis (output-channel tensor '
            'parallelism of the head convs) is not ported yet '
            '(ROADMAP.md section 1, item 1)')
    return Mesh(tuple(devices))


class Sharded(NamedTuple):
    """A global batch laid out over a mesh: ``shards[k]`` (a tensor, or a
    tuple, named tuple or dict of tensors) holds the k-th contiguous slice
    of the leading axis and lies on ``mesh.devices[k]``, as JAX's
    ``P('data')`` output sharding leaves it.  :meth:`gather` assembles the
    global batch on one device."""
    shards: list

    def gather(self, device=None):
        """The global batch on ``device`` (default: shard 0's), each
        tensor the concatenation of its shards in order."""
        first = tensors_of(self.shards[0])
        device = first[0].device if device is None else torch.device(device)
        per_shard = [tensors_of(s) for s in self.shards]
        # a copy to the host must be complete when the host reads it
        on_card = device.type == 'cuda'
        cat = iter([torch.cat([leaves[i].to(device, non_blocking=on_card)
                               for leaves in per_shard])
                    for i in range(len(first))])
        return tree_map(lambda _: next(cat), self.shards[0])


def batch_sharding(mesh: Mesh, batch_size: int) -> list[slice]:
    """The slice of the leading axis each shard holds, in device order:
    contiguous and equal, as ``P('data')`` lays a batch out.  A batch
    that does not divide over the ``data`` axis raises, as JAX's
    ``device_put`` does."""
    n = len(mesh.devices)
    if batch_size % n:
        raise ValueError(f'a batch of {batch_size} does not divide over '
                         f'the {n} devices of the data axis')
    b = batch_size // n
    return [slice(k * b, (k + 1) * b) for k in range(n)]


def shard_batch(batch, mesh: Mesh) -> Sharded:
    """``batch`` (a tensor, or a tuple or dict of tensors with one leading
    batch axis) cut by :func:`batch_sharding` and each slice copied to its
    card.  The copies are queued on each card's current stream and do not
    make the host wait: from another card, or from page-locked host memory
    (``pin_memory()``, the native loader's batches).  From pageable host
    memory CUDA stages each copy, and the host waits for it.  A slice
    already on its device is a view of ``batch``."""
    sizes = {t.shape[0] for t in tensors_of(batch)}
    if len(sizes) != 1:
        raise ValueError(f'shard_batch: leading axes differ {sorted(sizes)}')
    slices = batch_sharding(mesh, sizes.pop())
    return Sharded([
        tree_map(lambda t: t[sl].to(dev, non_blocking=True), batch)
        for sl, dev in zip(slices, mesh.devices)])


def replicate(module: nn.Module, mesh: Mesh) -> list[nn.Module]:
    """One copy of ``module`` on each device of the mesh, in device order
    (a device listed twice gets two copies).  Parameters and buffers are
    copied as they are, so every replica is bit-equal to ``module``; make
    the serving form (``models/layers.store_in_compute_dtype``) first."""
    return [copy.deepcopy(module).to(dev) for dev in mesh.devices]


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
