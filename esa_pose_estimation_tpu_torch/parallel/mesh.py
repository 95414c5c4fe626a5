"""Data and model parallelism: the counterpart of the JAX package's
``parallel/mesh.py``.

JAX shards a batch over the ``data`` axis of a device mesh, places the
large kernels over its ``model`` axis (``param_sharding``), and compiles
one program for all the devices.  The port has two counterparts:

* **One process, several cards** (serving and evaluation):
  :func:`make_mesh` lists the cards of the ``data`` axis (:class:`Mesh`),
  :func:`batch_sharding` and :func:`shard_batch` cut a batch into
  contiguous slices of its leading axis in device order, as
  ``P('data')`` lays them out, and copy each slice to its card
  (:class:`Sharded`), and :func:`replicate` puts one copy of a module on
  each card.  ``pipeline.make_sharded_pipeline`` and
  ``train/state.make_sharded_eval_step`` run one program per card on
  them.  Its ``model`` axis has extent 1.
* **One process per card** (training): the process group of
  ``parallel/distributed.initialize``, laid out as a (data, model)
  :class:`ProcessMesh` by :func:`make_process_mesh` (``make_mesh(n_data,
  n_model)`` with ``n_model > 1``): rank r sits at (r // n_model,
  r % n_model), JAX's row-major ``reshape(n_data, n_model)`` and
  ``init_device_mesh``'s.  :func:`shard_state` splits the output channels
  of the convs that JAX's rule selects (:func:`param_sharding`: at least
  ``min_shard_elems`` elements, two or more axes, output channels that
  divide over the axis) over the ranks of each model group, with their
  Adam moments; everything else (biases, BatchNorm's parameters and
  statistics, the small convs, Adam's step) stays whole on every rank.  In
  ``hrnet_esa`` the rule splits 28 convs, 9,593,856 of its 10,836,632
  parameters (88.5%): the 480->480 head conv, the 3x3 convs of branches 3
  and 4 in ``HRModule_1`` and ``HRModule_2``, two transition convs and
  five fuse convs; in ``hrnet_tiny`` the 120->120 head conv alone.  A
  split conv sums its input's gradient over the model group and gathers
  its output (``parallel/tensor_parallel``).  :func:`wrap_data_parallel`
  wraps the model in DistributedDataParallel over the data group, which
  broadcasts its first rank's parameters once, so every replica starts
  equal, and averages the gradients in its backward; BatchNorm's
  statistics and the loss's mean run over the data group too.  Each
  process reads its data slice of the global batch
  (``distributed.local_slice``, the native loader's ``process_id``); the
  global batch is never assembled.  :func:`gather_state` rebuilds the
  whole model and Adam state from the slices, as reading a sharded
  ``jax.Array`` does.  On an (n, 1) mesh nothing is split and the data
  group is the whole group: the steps are those of data parallelism alone,
  bit for bit.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from esa_pose_estimation_tpu_torch.models.layers import BatchNorm, Conv
from esa_pose_estimation_tpu_torch.parallel.tensor_parallel import Axis
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


def _factor(n_devices: int, n_data: int | None, n_model: int) -> int:
    """JAX's checks of a (data, model) factorization of ``n_devices``,
    with its messages: the mesh must use every given device (an idle card
    reads as a throughput regression).  Returns ``n_data``."""
    if n_model < 1 or n_model > n_devices:
        raise ValueError(f'n_model={n_model} with {n_devices} devices')
    if n_data is None:
        if n_devices % n_model:
            raise ValueError(
                f'{n_devices} devices do not factor into n_model='
                f'{n_model} (pass n_data or a device subset explicitly)')
        n_data = n_devices // n_model
    if n_data * n_model != n_devices:
        raise ValueError(f'mesh {n_data}x{n_model} uses '
                         f'{n_data * n_model} of {n_devices} devices; '
                         f'pass devices=... to use a subset deliberately')
    return n_data


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: Sequence | None = None):
    """A (data, model) mesh over every visible card, or over ``devices``;
    with ``n_model > 1`` and no ``devices``, the :class:`ProcessMesh` of
    the joined process group (:func:`make_process_mesh`).

    As in JAX, the factorization must use every given device, so
    ``n_data * n_model`` must equal the number of devices, with JAX's
    errors.  A one-process mesh has no ``model`` axis: ``devices`` with
    ``n_model > 1`` raises.

    ``devices`` may repeat a device: torch has one CPU device, so a CPU
    mesh of n shards is ``[torch.device('cpu')] * n``, and one card can
    hold several shards, each with its own replica and program.  A mesh
    is all CUDA or all CPU; without ``devices`` and without a card it
    raises.
    """
    if n_model > 1 and devices is None:
        return make_process_mesh(n_data, n_model)
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
    _factor(len(devices), n_data, n_model)
    if n_model > 1:
        raise NotImplementedError(
            f'n_model={n_model} over listed devices: the model axis spans '
            'processes, one per card; call make_mesh(n_data, n_model) '
            'without devices in a joined process group for a process mesh')
    return Mesh(tuple(devices))


class ProcessMesh(NamedTuple):
    """A (data, model) mesh of processes, one per card.  ``ranks[i][j]``
    is the rank at data coordinate i and model coordinate j;
    ``coordinate`` is this rank's.  ``data`` is the axis of this rank's
    column (the ranks that hold the other slices of the batch and the
    same slices of the parameters), ``model`` that of its row (the ranks
    that hold the same batch slice and the other parameter slices); an
    axis whose ranks are the whole group has the group None, the default
    group."""
    ranks: tuple[tuple[int, ...], ...]
    coordinate: tuple[int, int]
    data: Axis
    model: Axis

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}


def make_process_mesh(n_data: int | None = None, n_model: int = 1,
                      ranks: Sequence[int] | None = None
                      ) -> ProcessMesh | None:
    """The (data, model) mesh of the ranks of the joined process group,
    or of ``ranks`` (JAX's device subset), laid out row-major, with JAX's
    checks and messages.  Every rank of the group calls it, in the same
    order as every other call that makes groups: it makes each column's
    and each row's group.  A rank outside ``ranks`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError('make_process_mesh: no process group is joined '
                           '(parallel/distributed.initialize): a model axis '
                           'spans processes, one per card')
    world = list(range(dist.get_world_size()))
    ranks = world if ranks is None else [int(r) for r in ranks]
    n_data = _factor(len(ranks), n_data, n_model)
    grid = [ranks[i * n_model:(i + 1) * n_model] for i in range(n_data)]
    me = dist.get_rank()

    def axis(members: list[int]) -> Axis:
        group = None if members == world else dist.new_group(members)
        return Axis(group, len(members),
                    members.index(me) if me in members else -1)
    cols = [axis([row[j] for row in grid]) for j in range(n_model)]
    rows = [axis(row) for row in grid]
    if me not in ranks:
        return None
    i, j = divmod(ranks.index(me), n_model)
    return ProcessMesh(tuple(map(tuple, grid)), (i, j), cols[j], rows[i])


def param_sharding(model: nn.Module, mesh,
                   min_shard_elems: int = 1 << 16) -> list[str]:
    """The names of the parameters JAX's rule splits over the ``model``
    axis of ``mesh``, in ``model.named_parameters()`` order: those with
    two or more axes, at least ``min_shard_elems`` elements and output
    channels (the port's axis 0, JAX's last) that divide over the axis.
    No name on a mesh whose model axis has extent 1."""
    n = mesh.shape[MODEL_AXIS]
    return [name for name, p in model.named_parameters()
            if n > 1 and p.ndim >= 2 and p.numel() >= min_shard_elems
            and p.shape[0] % n == 0]


def shard_state(state, mesh: ProcessMesh,
                min_shard_elems: int = 1 << 16):
    """Place ``state`` (a ``train/state.TrainState``) on ``mesh``, in
    place, and return it: every rank of a model group first takes its
    first rank's parameters, statistics and Adam moments; then each conv
    :func:`param_sharding` selects keeps this rank's rows of its output
    channels, its Adam moments likewise (Adam's step stays whole), and
    runs split (``models/layers.Conv.model_axis``); every BatchNorm takes
    its statistics over the data group.  Call it before
    :func:`wrap_data_parallel` and before any graph captures the state:
    it replaces the split weights' storage, and a graph captured before
    raises at its next replay (``utils/graphs.check_pointers``)."""
    if isinstance(state.train_model, DistributedDataParallel):
        raise ValueError('shard_state: the model is wrapped for data '
                         'parallelism already; shard it first, then '
                         'wrap_data_parallel(model, mesh)')
    if state.mesh is not None:
        raise ValueError('shard_state: the state is placed on a mesh '
                         'already')
    model, opt, axis = state.model, state.optimizer, mesh.model
    split = param_sharding(model, mesh, min_shard_elems)
    modules = dict(model.named_modules())
    for name in split:
        owner = modules[name.rpartition('.')[0]]
        if not (isinstance(owner, Conv) and name.endswith('.weight')):
            raise ValueError(f'shard_state: {name} is selected by the rule, '
                             f'but only models/layers.Conv weights can be '
                             f'split ({type(owner).__name__})')
    if axis.size > 1:   # Adam's step may lie on the host, the same on all
        from esa_pose_estimation_tpu_torch.train.state import state_tensors
        dev = next(model.parameters()).device
        src = mesh.ranks[mesh.coordinate[0]][0]
        with torch.no_grad():
            for t in state_tensors(state):
                if t.device == dev:
                    dist.broadcast(t, src, group=axis.group)
    for name in split:
        conv = modules[name.rpartition('.')[0]]
        w = conv.weight
        rows = w.shape[0] // axis.size
        keep = slice(axis.index * rows, (axis.index + 1) * rows)
        moments = {} if opt is None else opt.state.get(w, {})
        for k, v in moments.items():
            if isinstance(v, torch.Tensor) and v.shape == w.shape:
                moments[k] = v[keep].clone()
        with torch.no_grad():
            w.data = w.data[keep].clone()
        w.grad = None
        conv.out_channels = rows
        conv.model_axis = axis
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_axis = mesh.data
    state.mesh = mesh
    return state


def split_convs(model: nn.Module) -> list[Conv]:
    """The convs of ``model`` that run split over a model axis."""
    return [m for m in model.modules()
            if isinstance(m, Conv) and m.model_axis is not None]


def _gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The slices ``t`` of the ranks of ``axis`` joined along axis 0, in
    ``t``'s memory format."""
    parts = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    out = torch.cat(parts)
    if t.dim() == 4 and not t.is_contiguous():
        return out.contiguous(memory_format=torch.channels_last)
    return out


def gather_state(state):
    """A new, unsplit ``TrainState`` with the whole model and Adam state
    of ``state``, a state :func:`shard_state` placed on a mesh: what
    reading a sharded ``jax.Array`` as numpy gives.  Every rank of a model
    group calls it (one all-gather per split tensor), and each gets the
    whole state; ``state`` is left as it was.  The new state has no mesh
    and no DistributedDataParallel wrapper: it serves, is saved
    (``train/checkpoint``) or trains in one process."""
    from esa_pose_estimation_tpu_torch.train.state import TrainState
    split = {id(m.weight): m.model_axis for m in split_convs(state.model)}
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for conv in split_convs(model):
            conv.weight.data = _gather_rows(conv.weight.data,
                                            conv.model_axis)
            conv.out_channels = conv.weight.shape[0]
            conv.model_axis = None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_axis = None
    old = state.optimizer
    if old is None:
        return TrainState(model, None, state.schedule, state.step)
    index = {id(p): i for i, p in enumerate(state.model.parameters())}
    params = list(model.parameters())
    opt = type(old)([{**{k: v for k, v in g.items() if k != 'params'},
                      'params': [params[index[id(p)]] for p in g['params']]}
                     for g in old.param_groups])
    sd = old.state_dict()
    order = [p for g in old.param_groups for p in g['params']]
    for i, st in sd['state'].items():
        axis = split.get(id(order[i]))
        sd['state'][i] = {
            k: (v if not isinstance(v, torch.Tensor) else
                _gather_rows(v, axis) if axis is not None
                and v.shape == order[i].shape else v.clone())
            for k, v in st.items()}
    opt.load_state_dict(sd)
    return TrainState(model, opt, state.schedule, state.step)


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


def wrap_data_parallel(model: nn.Module, mesh: ProcessMesh | None = None
                       ) -> DistributedDataParallel:
    """``model`` (on this process's card, or the CPU under gloo) as a
    DistributedDataParallel replica over the whole group, or over the data
    group of ``mesh`` (after :func:`shard_state`), ready to be captured in
    a CUDA graph (``train/state.make_train_steps``).

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
    group = None if mesh is None else mesh.data.group
    if dev.type != 'cuda':
        return DistributedDataParallel(model, broadcast_buffers=False,
                                       process_group=group)
    caller = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        ddp = DistributedDataParallel(model, device_ids=[dev.index],
                                      broadcast_buffers=False,
                                      process_group=group)
    caller.wait_stream(side)
    torch.autograd.graph.set_warn_on_accumulate_grad_stream_mismatch(False)
    ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
    return ddp
