"""Train state, the stepped learning-rate schedule, and the train and eval
steps (torch port of the JAX package's ``train/state.py``; reference
main.py:237-424).

Adam at optax's defaults (betas 0.9/0.999, eps 1e-8) with the stepped epoch
schedule (main.py:298-299 through adjust_learning_rate :223-234), and the
weighted HeatmapWing loss (loss.py:116-129); the detector's cosine decay
(:func:`cosine_schedule`).  Several processes train one model through
``TrainState.train_model``, the ``DistributedDataParallel`` wrapper of
``parallel/mesh.wrap_data_parallel``, whose backward averages the
gradients over the processes; each step's loss is the mean over them
(``parallel/distributed.global_mean``), the global batch's, as the JAX
package logs it.  :func:`make_train_steps` is the JAX package's jitted
steps: ``n_inner`` steps of batch making, forward, backward and Adam as
one CUDA graph on the card, one replay per call, for one process or
several; :func:`make_scan_step` is ``make_sharded_scan_step`` on it.
Under several processes the graph holds DDP's gradient all-reduces, the
BatchNorm statistics' all-reduces and the loss's: the JAX mesh's sharded
steps, one process per card.  A state placed on a process mesh with a
``model`` axis (``parallel/mesh.shard_state``) runs its split convs'
collectives in the same steps and graphs, and its data-axis reductions
over the data group: ``make_sharded_train_step(mesh, state=)`` and
``make_sharded_scan_step(..., state=)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from esa_pose_estimation_tpu_torch.obs import profiling
from esa_pose_estimation_tpu_torch.obs.profiling import stage
from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
from esa_pose_estimation_tpu_torch.parallel.distributed import global_mean
from esa_pose_estimation_tpu_torch.train.loss import weighted_heatmap_loss
from esa_pose_estimation_tpu_torch.utils import graphs
from esa_pose_estimation_tpu_torch.utils.config import TrainConfig


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int
                ) -> Callable[[int], float]:
    """Stepped schedule as a function of the optimizer step: lr_values[i]
    from epoch lr_boundaries[i-1] on (absolute values, main.py:298-299),
    ``optax.piecewise_constant_schedule``'s rule: a boundary's scale applies
    once ``step >= boundary``.

    Duplicate boundaries (a short run rescales epochs and can collide, e.g.
    --epochs 2 gives (2, 2, 3)) compose their scales at the shared step, so
    every prescribed decade of decay applies.  Mismatched value and
    boundary counts raise.
    """
    if len(cfg.lr_values) != len(cfg.lr_boundaries) + 1:
        raise ValueError(
            f'need len(lr_values) == len(lr_boundaries) + 1, got '
            f'{len(cfg.lr_values)} values / {len(cfg.lr_boundaries)} '
            f'boundaries')
    scales: dict[int, float] = {}
    prev = cfg.lr_values[0]
    for epoch, value in zip(cfg.lr_boundaries, cfg.lr_values[1:]):
        step = epoch * steps_per_epoch
        scales[step] = scales.get(step, 1.0) * (value / prev)
        prev = value
    init = cfg.lr_values[0]

    def schedule(step: int) -> float:
        lr = init
        for boundary, scale in scales.items():
            if step >= boundary:
                lr *= scale
        return lr

    return schedule


def cosine_schedule(lr: float, total_steps: int, alpha: float = 0.01
                    ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha)``: from ``lr``
    down to ``alpha * lr`` along a half cosine over ``total_steps``, then
    flat; the constant ``lr`` when ``total_steps`` is 0."""
    if total_steps <= 0:
        return lambda step: lr

    def schedule(step: int) -> float:
        frac = min(step, total_steps) / total_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                     + alpha)

    return schedule


class TrainState:
    """The model, its Adam optimizer, the schedule and the step count (the
    number of optimizer updates so far, optax's ``count``).  An evaluation
    holds the model alone (``optimizer=None``).

    ``train_model`` is what a train step runs forward: the model itself, or
    its ``DistributedDataParallel`` wrapper when several processes train
    it (``parallel/mesh.wrap_data_parallel``).  Checkpoints hold ``model``,
    so their names do not depend on the wrapper.  ``mesh`` is the
    ``parallel/mesh.ProcessMesh`` that ``shard_state`` placed the state
    on, or None."""

    def __init__(self, model: nn.Module,
                 optimizer: torch.optim.Optimizer | None = None,
                 schedule: Callable[[int], float] | None = None,
                 step: int = 0):
        self.model = model
        self.train_model: nn.Module = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step
        self.mesh = None


@contextlib.contextmanager
def deterministic_cudnn():
    """``torch.backends.cudnn.deterministic`` on while a training step
    runs, warms up or is captured, and the process's own setting back
    after it: cuDNN's heuristics pick weight-gradient algorithms that add
    with atomics for some convolutions (the detector's, ResNet-8s'), and
    two runs of one step then differ (``cli/mfu_experiments
    --determinism``).  With it and the half-pixel resize's own backward
    (``models/layers._HalfPixelResize``) training on the card repeats bit
    for bit; serving keeps cuDNN's free choice.  A captured graph keeps
    the algorithms chosen in its capture."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Adam (optax's defaults) over ``model``'s parameters, which must
    already be on their device, at the schedule's rate."""
    schedule = lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, schedule)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _data_group(state: TrainState):
    """The group a step's data-axis reductions run over (None: all)."""
    return None if state.mesh is None else state.mesh.data.group


def grad_norm(state: TrainState) -> torch.Tensor:
    """The global norm of the model's gradients, ``optax.global_norm`` of
    JAX's global gradients: under a ``model`` axis the split weights'
    squares summed over the model group (one all-reduce) added to those
    of the whole ones."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    if state.mesh is None or state.mesh.model.size == 1:
        return global_norm([p.grad for p in params])
    split = {id(m.weight) for m in mesh_mod.split_convs(state.model)}
    sq = [torch.stack(torch._foreach_norm(
        [p.grad for p in params if (id(p) in split) == part])
    ).square().sum() for part in (True, False)]
    dist.all_reduce(sq[0], group=state.mesh.model.group)
    return torch.sqrt(sq[0] + sq[1])


def train_step(state: TrainState, batch: dict[str, torch.Tensor],
               loss_w: float = 10.0) -> dict[str, torch.Tensor]:
    """One optimization step on batch {'image': (B, H, W, C), 'heatmaps':
    (B, H, W, K), 'weights': (B, H, W, K)}: a train-mode forward (batch
    statistics; the BatchNorm running statistics update), the loss, its
    gradients, Adam at the schedule's rate for this step.  Returns the
    loss and the gradients' global norm as device tensors: no host sync.
    Under several processes the loss is the mean over the processes (the
    global batch's) and the norm is that of the gradients averaged over
    them."""
    return optimize(state, lambda model: heatmap_step_loss(model, batch,
                                                            loss_w))


def optimize(state: TrainState,
             loss_fn: Callable[[nn.Module], torch.Tensor]
             ) -> dict[str, torch.Tensor]:
    """One Adam step on ``loss_fn(state.train_model)``, a train-mode
    forward and its scalar loss: the backward (``DistributedDataParallel``
    averages the gradients over the processes inside it), the gradients'
    global norm, the update at the schedule's rate for this step.  Returns
    the loss, as the mean over the processes of the data axis
    (``global_mean``), and the norm (:func:`grad_norm`) as device tensors.
    It runs under :func:`deterministic_cudnn`, in the stages ``forward``,
    ``backward`` and ``optimizer`` (``obs/profiling.stage``)."""
    model, opt = state.train_model, state.optimizer
    model.train()
    with deterministic_cudnn():
        with stage('forward'):
            loss = loss_fn(model)
        with stage('backward'):
            opt.zero_grad(set_to_none=True)
            loss.backward()
    with stage('optimizer'):
        norm = grad_norm(state)
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()
    state.step += 1
    return {'loss': global_mean(loss.detach(), _data_group(state)),
            'grad_norm': norm.detach()}


class BatchFn(NamedTuple):
    """A batch source in the port's two halves: ``draw(generator)`` makes
    one batch's random draws (a tree of tensors, e.g.
    ``data/synthetic.draw_batch``), ``make(draws)`` the batch from them
    with no randomness (``make_batch(..., draws=)``)."""
    draw: Callable[[torch.Generator], object]
    make: Callable[[object], dict[str, torch.Tensor]]


def heatmap_step_loss(model: nn.Module, batch: dict[str, torch.Tensor],
                      loss_w: float = 10.0) -> torch.Tensor:
    """The keypoint step's forward and loss on a model-ready batch."""
    return weighted_heatmap_loss(model(batch['image']), batch['heatmaps'],
                                 batch['weights'], W=loss_w)


StepLoss = Callable[[nn.Module, object], torch.Tensor]


def run_steps(state: TrainState, loss_fn: StepLoss, inputs: list
              ) -> torch.Tensor:
    """The steps of :func:`make_train_steps` run eagerly, one
    :func:`optimize` each: its CPU path.  Returns the losses
    (len(inputs),)."""
    return torch.stack([optimize(state, lambda m, x=x: loss_fn(m, x))['loss']
                        for x in inputs])


def _capturable(opt: torch.optim.Optimizer, device) -> torch.Tensor:
    """Adam as a graph needs it: ``capturable``, its 'step' counts on the
    card (in place from then on), and the rate a device tensor shared by
    the groups, which each captured step writes.  Adam then takes its bias
    correction in f32 on the card, not in f64 on the host.  Returns the
    rate's tensor."""
    lr = torch.zeros((), dtype=torch.float32, device=device)
    for group in opt.param_groups:
        group['capturable'] = True
        group['lr'] = lr
    for st in opt.state.values():
        if 'step' in st:
            st['step'] = st['step'].to(device=device, dtype=torch.float32)
    return lr


def _optimizer_tensors(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    out = []
    for st in opt.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """A train state's parameters, buffers and optimizer state."""
    return (list(state.model.parameters()) + list(state.model.buffers())
            + _optimizer_tensors(state.optimizer))


DDP_WARM_UP_STEPS = 11


def warm_up_steps(state: TrainState) -> int:
    """The eager steps before a capture: 1, or under
    ``DistributedDataParallel`` 11, PyTorch's rule for capturing DDP's
    whole backward (its first iterations read timings back to the host and
    rebuild the gradient buckets).  Every rank runs the same count: the
    steps' collectives pair up across the ranks."""
    return (DDP_WARM_UP_STEPS
            if isinstance(state.train_model, DistributedDataParallel) else 1)


def _warm_up_restored(state: TrainState, fn: Callable[[], object],
                      device, steps: int = 1) -> None:
    """``fn()`` ``steps`` times on a side stream (Adam's moments, the
    gradients, cuBLAS and cuDNN, DDP's buckets and NCCL's communicator are
    set up there, not in the capture), then the model, the optimizer and
    the step count put back as they were, bit for bit.  State that the
    calls created is Adam's, which starts at zero."""
    saved = {id(t): t.detach().clone() for t in state_tensors(state)}
    step = state.step
    graphs.warm_up(lambda: [fn() for _ in range(steps)], device)
    with torch.no_grad():
        for t in state_tensors(state):
            if id(t) in saved:
                t.copy_(saved[id(t)])
            else:
                t.zero_()
    state.step = step


def make_train_steps(state: TrainState, loss_fn: StepLoss, n_inner: int = 1
                     ) -> Callable[[list], torch.Tensor]:
    """A compiled training program, the counterpart of JAX's jitted train
    steps (``make_sharded_train_step`` at ``n_inner`` = 1, the scan of
    ``make_sharded_scan_step``, the detector's and LINEMOD's steps).
    Returns ``fn(inputs) -> losses (n_inner,)``, a device tensor, which
    advances ``state`` by ``n_inner`` steps in place.

    ``inputs`` holds one tree of tensors per step: the step's random draws
    (drawn before the call) and its data (a loader's batch), and
    ``loss_fn(model, inputs[j])`` makes the batch from them with no
    randomness, runs the train-mode forward and returns the loss.  On the
    card a CUDA graph holds ``n_inner`` x (``loss_fn`` -> backward ->
    Adam), captured at the first call after :func:`warm_up_steps` eager
    steps whose effects are undone, and replayed by every call with the
    inputs copied into its static buffers; the schedule's rate of each
    step is written into a device tensor first.  Under
    ``DistributedDataParallel`` (``state.train_model``, made by
    ``parallel/mesh.wrap_data_parallel`` in a group that
    ``parallel/distributed.initialize`` joined) the graph holds each
    step's collectives: DDP's bucket all-reduces, the global-batch
    BatchNorm's all-reduces forward and backward, the loss's mean over the
    ranks; every rank captures the same graphs in the same order, and
    replays them together.  A capture that fails raises.  Adam runs
    ``capturable`` with a tensor rate (:func:`_capturable`; the
    checkpoints store the plain form); the gradients' norm is not
    computed.  The warm-up and the capture run
    under :func:`deterministic_cudnn`.  Every call must give the inputs of
    the first in shape and dtype.  The graph reads the model, its
    gradients and the optimizer where they lie, and each replay checks
    that they were not replaced (``utils/graphs.check_pointers``).  The
    losses are the means over the ranks.  On the CPU the same steps run
    eagerly (:func:`run_steps`).  Each call is one record of the process's
    recorder (``obs/profiling.Recorder``), as a ``utils/graphs.Graphed``
    call is, with each step's stages ``forward``, ``backward`` and
    ``optimizer``.
    """
    if n_inner < 1:
        raise ValueError(f'make_train_steps: n_inner={n_inner} < 1')
    device = next(state.model.parameters()).device
    if device.type != 'cuda':
        # recorded as the graph's calls are, the steps' stages host-stamped
        graph = profiling.recorder().new_graph()
        return lambda inputs: profiling.recorder().eager(
            graph, device, lambda: run_steps(state, loss_fn, inputs))
    return StepGraph(state, loss_fn, n_inner, device)


class StepGraph:
    """:func:`make_train_steps`'s ``fn`` on the card.  ``capture`` holds
    the graph's :class:`~utils.graphs.Captured` once there is one."""

    def __init__(self, state: TrainState, loss_fn: StepLoss, n_inner: int,
                 device: torch.device):
        self.state, self.loss_fn = state, loss_fn
        self.n_inner, self.device = n_inner, device
        self.lr = _capturable(state.optimizer, device)
        self.lrs = torch.zeros((n_inner,), dtype=torch.float32,
                               device=device)
        self.inputs: list = []
        self.key: tuple = ()
        self.capture: graphs.Captured | None = None
        self.warmed = False

    def _step(self, j: int) -> torch.Tensor:
        """One step as the graph holds it: the gradients stay allocated
        (zeroed, not dropped) and Adam reads its rate from the tensor in
        its groups; the stages ``forward``, ``backward`` and ``optimizer``
        are stamped in the capture.  Returns the loss, the mean over the
        ranks."""
        model, opt = self.state.train_model, self.state.optimizer
        self.lr.copy_(self.lrs[j])
        with stage('forward'):
            loss = self.loss_fn(model, self.inputs[j])
        with stage('backward'):
            opt.zero_grad(set_to_none=False)
            loss.backward()
        with stage('optimizer'):
            opt.step()
        return global_mean(loss.detach(), _data_group(self.state))

    def _rates(self) -> None:
        st = self.state
        for j in range(self.n_inner):
            self.lrs[j].fill_(st.schedule(st.step + j))
        st.train_model.train()

    def run_eagerly(self, inputs: list) -> torch.Tensor:
        """The steps of a replay launched one by one, with no graph: the
        same kernels and Adam's capturable arithmetic, which a replay is
        held to bit for bit.  For a state that has no graph.  Its first
        call warms up as the capture does (:func:`warm_up_steps` steps,
        undone): DDP all-reduces its first iteration's gradients in
        buckets of the parameters' order and later ones in buckets of the
        order the gradients came in, and a sum over four cards depends on
        where each element lies in its bucket."""
        self._rates()
        self.inputs = inputs
        with deterministic_cudnn():
            if not self.warmed:
                _warm_up_restored(self.state, lambda: self._step(0),
                                  self.device, warm_up_steps(self.state))
                self.warmed = True
            losses = torch.stack([self._step(j)
                                  for j in range(self.n_inner)])
        self.inputs = []
        self.state.step += self.n_inner
        return losses

    def __call__(self, inputs: list) -> torch.Tensor:
        st, n = self.state, self.n_inner
        if len(inputs) != n:
            raise ValueError(f'StepGraph: {len(inputs)} inputs for {n} '
                             f'steps')
        # one record of the recorder, in the phases of utils/graphs.Graphed
        with profiling.recorder().call() as call:
            key = graphs.graph_key(tuple(inputs), {})
            first = self.capture is None
            if first:
                self._rates()
                self._capture(inputs, key)
            elif key != self.key:
                raise ValueError('StepGraph: the inputs differ in shape or '
                                 'dtype, or a flag of graphs.lever_flags '
                                 'differs, from the capture\'s')
            graphs.check(self.capture)
            call.copy_in(self.capture.graph_id, self.device)
            if not first:
                self._rates()
                for buf, t in zip(graphs.tensors_of(self.inputs),
                                  graphs.tensors_of(inputs)):
                    buf.copy_(t)
            call.phase('launch')
            graphs.launch(self.capture)
            st.step += n
            call.phase('clone')
            out = self.capture.outputs.clone()
        return out

    def _capture(self, inputs: list, key: tuple) -> None:
        st, n = self.state, self.n_inner
        self.inputs, self.key = graphs.tree_map(torch.clone, inputs), key
        # what the graph reads in place, by a closure that does not hold
        # self: the capture must not keep its own graph alive
        model_reads = graphs.tensor_reader([st.model], grads=True)
        opt = st.optimizer
        with torch.cuda.device(self.device), deterministic_cudnn():
            _warm_up_restored(st, lambda: self._step(0), self.device,
                              warm_up_steps(st))
            self.warmed = True
            self.capture = graphs.capture(
                lambda: torch.stack([self._step(j) for j in range(n)]),
                self.device, lambda: model_reads() + _optimizer_tensors(opt))


class _Scan:
    """:func:`make_scan_step`'s ``fn``: the draws, then the steps."""

    def __init__(self, steps: Callable[[list], torch.Tensor],
                 draw: Callable[[torch.Generator], object], n_inner: int):
        self.steps, self.draw, self.n_inner = steps, draw, n_inner

    @property
    def capture(self) -> graphs.Captured | None:
        return getattr(self.steps, 'capture', None)

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        return self.steps([self.draw(generator)
                           for _ in range(self.n_inner)])


def make_scan_step(state: TrainState, batch_fn: BatchFn, n_inner: int,
                   loss_w: float = 10.0) -> Callable[[torch.Generator],
                                                     torch.Tensor]:
    """The JAX ``make_sharded_scan_step``: ``n_inner`` train steps fused.
    Returns ``fn(generator) -> losses (n_inner,)``, a device tensor, which
    advances ``state`` by ``n_inner`` steps in place.

    Each call draws the ``n_inner`` batches' random numbers from
    ``generator`` first (``batch_fn.draw``, in the per-step loop's order,
    so the stream is that loop's), then runs :func:`make_train_steps`'s
    program of ``n_inner`` x (``batch_fn.make`` -> forward -> loss ->
    backward -> Adam): one CUDA graph replay on the card, the same steps
    eagerly on the CPU.  ``fn.capture`` holds the graph's
    :class:`~utils.graphs.Captured` once there is one.
    """
    steps = make_train_steps(
        state, lambda model, draws: heatmap_step_loss(
            model, batch_fn.make(draws), loss_w), n_inner)
    return _Scan(steps, batch_fn.draw, n_inner)


@torch.no_grad()
def eval_step(state: TrainState, batch: dict[str, torch.Tensor],
              loss_w: float = 10.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward + loss with frozen statistics: (heatmaps, loss)."""
    state.model.eval()
    out = state.model(batch['image'])
    return out, weighted_heatmap_loss(out, batch['heatmaps'],
                                      batch['weights'], W=loss_w)


@torch.no_grad()
def _forward_and_loss(model: nn.Module, batch: dict[str, torch.Tensor],
                      loss_w: float) -> tuple[torch.Tensor, torch.Tensor]:
    out = model(batch['image'])
    return out, weighted_heatmap_loss(out, batch['heatmaps'],
                                      batch['weights'], W=loss_w)


def make_sharded_eval_step(mesh, loss_w: float = 10.0) -> Callable:
    """The JAX ``make_sharded_eval_step``: returns ``fn(replicas, batch)
    -> (heatmaps, losses)`` over the ``data`` axis of ``mesh``
    (``parallel/mesh.make_mesh``) in one process.

    ``replicas`` is ``parallel/mesh.replicate(model, mesh)``, one copy per
    device, each run with frozen statistics; ``batch`` holds the global
    batch's ``image``, ``heatmaps`` and ``weights``, sharded by
    ``mesh.shard_batch``.  Each card runs its shard's forward and loss as
    one CUDA graph per shape (``utils/graphs.Graphed``, as
    ``eval/eval_cache.EvalCache`` does; eagerly on CPU devices), every
    card's launched before any is waited on.  ``heatmaps`` is a
    ``mesh.Sharded``, shard k on card k; ``losses[k]``, on card k, is the
    global batch's :func:`eval_step` loss, the mean of the shards' equal
    means added in device order, so every card holds the same value, as
    JAX's replicated output does."""
    programs = [graphs.Graphed(_forward_and_loss) for _ in mesh.devices]

    def run(replicas, batch: dict[str, torch.Tensor]):
        if len(replicas) != len(mesh.devices):
            raise ValueError(f'{len(replicas)} replicas for a mesh of '
                             f'{len(mesh.devices)} devices')
        shards = mesh_mod.shard_batch(
            {k: batch[k] for k in ('image', 'heatmaps', 'weights')},
            mesh).shards
        outs = []
        for program, model, shard in zip(programs, replicas, shards):
            model.eval()
            outs.append(program(model, shard, loss_w))
        losses = []
        for dev in mesh.devices:
            total = outs[0][1].to(dev)
            for _, loss in outs[1:]:
                total = total + loss.to(dev)
            losses.append(total / len(outs))
        return mesh_mod.Sharded([hm for hm, _ in outs]), losses
    return run
