"""Training through ``train/state.make_train_steps``: one graph call runs
``traffic.n_inner`` steps of ``traffic.batch`` rows on each of
``ctx.world`` processes, one per card, back to back, the losses read on
the host after each call.

Under several processes each joins the group with
``parallel/distributed.initialize`` (a rendezvous over TCP on a local
port) and trains through ``parallel/mesh.wrap_data_parallel``; rank 0
decides when the window ends and tells the others after each call, so
every rank replays the same graphs.  Each rank makes its own pool of
``traffic.pool_batches`` model-ready batches from the seed and its rank;
a call takes ``n_inner`` of them in turn.

The program's first call (capture and first replay) is made in set-up:
its losses and the state after it are kept for the check, and the same
state trains on in the window.  One call of the window, the first to
start after a share of the window drawn from the seed (rank 0's clock),
is judged too: the state (parameters, Adam's moments and step, running
statistics) is copied before and after it into buffers made in set-up,
so that the check can follow that call from the state it started from.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from h100_bench import check, harness, trace, traffic
from h100_bench.reference import serve as ref_serve
from h100_bench.reference import train as ref_train
from h100_bench.reference import weights as ref_weights


class Train:
    def __init__(self, ctx):
        self.ctx, self.cfg = ctx, ctx.config
        self.traffic = ctx.workload['traffic']
        self.dev = ctx.device
        self.n_inner = self.traffic['n_inner']
        self.attempted = self.failed = 0
        self.r5: dict | None = None

    def batches(self, i: int) -> list:
        n = len(self.pool)
        return [self.pool[(i * self.n_inner + j) % n]
                for j in range(self.n_inner)]

    def setup(self) -> None:
        from esa_pose_estimation_tpu_torch.parallel import distributed
        from esa_pose_estimation_tpu_torch.parallel import mesh
        from esa_pose_estimation_tpu_torch.train import state as tstate
        from esa_pose_estimation_tpu_torch.utils.config import TrainConfig
        ctx, cfg, tr = self.ctx, self.cfg, self.traffic
        if ctx.world > 1:
            distributed.initialize(f'localhost:{ctx.port}', ctx.world,
                                   ctx.rank, device=self.dev.type)
        self.model = ctx.program_model(train=True)
        # TrainConfig's defaults: lr 1e-4 until epoch 80 of 1000 steps
        self.state = tstate.create_train_state(self.model, TrainConfig(),
                                               1000)
        if ctx.world > 1:
            self.state.train_model = mesh.wrap_data_parallel(self.model)
        self.pool = traffic.train_pool(ctx.seed, ctx.rank, tr,
                                       cfg['num_keypoints'], cfg['crop_size'],
                                       cfg['sigma'], self.dev)
        loss_w = cfg['loss_w']
        self.steps = tstate.make_train_steps(
            self.state, lambda m, b: tstate.heatmap_step_loss(m, b, loss_w),
            self.n_inner)
        self.first_losses = self.steps(self.batches(0)).detach().clone()
        opt = self.state.optimizer
        self.after = {n: p.detach().clone()
                      for n, p in self.model.named_parameters()}
        self.moment = {n: opt.state[p]['exp_avg_sq'].detach().clone()
                       for n, p in self.model.named_parameters()}
        self.stats = {n: b.detach().clone()
                      for n, b in self.model.named_buffers()}
        self.live = self._state_tensors()
        self.snap = {w: {k: v.detach().clone() for k, v in self.live.items()}
                     for w in ('before', 'after')}
        # the judged call: the first to start past this share of the window
        self.pick = random.Random(traffic.stream_seed(
            ctx.seed, 'judged_call')).uniform(0.1, 0.5)
        self.judged: int | None = None
        for i in range(1, tr['warm_up_calls']):
            self.call(i)
        self.attempted = self.failed = 0
        harness.steady()

    def _state_tensors(self) -> dict:
        """What a call changes, by (kind, name): each parameter, its Adam
        moments and step, each floating buffer."""
        opt = self.state.optimizer
        out = {}
        for n, p in self.model.named_parameters():
            out['param', n] = p
            for k in ('exp_avg', 'exp_avg_sq', 'step'):
                out[k, n] = opt.state[p][k]
        for n, b in self.model.named_buffers():
            if b.is_floating_point():
                out['buffer', n] = b
        return out

    def snapshot(self, when: str) -> None:
        """The state as it is now, into the buffers made in set-up for
        ``when`` ('before' or 'after' the judged call)."""
        with torch.no_grad():
            torch._foreach_copy_(list(self.snap[when].values()),
                                 list(self.live.values()))

    def launch(self, i: int) -> torch.Tensor:
        ts = time.perf_counter()
        losses = self.steps(self.batches(i))
        self.host_s = time.perf_counter() - ts
        return losses

    def finish(self, losses: torch.Tensor) -> None:
        """The losses on the host: a step fails where its loss is not
        finite."""
        host = losses.cpu()
        self.last_losses = host
        self.attempted += host.numel()
        self.failed += int((~torch.isfinite(host)).sum())

    def call(self, i: int) -> None:
        self.finish(self.launch(i))

    def judge(self, i: int) -> None:
        """Call ``i``, the one the check follows, between two copies of
        the state."""
        self.snapshot('before')
        self.call(i)
        self.snapshot('after')
        self.judged, self.judged_losses = i, self.last_losses

    def start(self) -> dict[str, torch.Tensor]:
        """The artifact the program started from (parameters and running
        statistics), on this rank's card."""
        if self.r5 is None:
            self.r5 = ref_weights.read_state_dict(self.ctx.weights_path())
        return {k: v.to(self.dev) for k, v in self.r5.items()}

    def _stat_names(self) -> list[str]:
        """The running statistics the artifact holds."""
        if self.r5 is None:
            self.r5 = ref_weights.read_state_dict(self.ctx.weights_path())
        return [n for kind, n in self.live if kind == 'buffer'
                and n in self.r5]

    def norms(self) -> dict:
        """This rank's leaf norms after the first call, against the
        artifact the program started from."""
        start = self.start()
        return check.leaf_norms(self.after, start, self.moment, self.n_inner,
                                {n: s for n, s in self.stats.items()
                                 if n in start}, start)

    def window_record(self) -> tuple[torch.Tensor, dict]:
        """The judged call on this rank: its losses, and the leaf norms of
        the state after it against the state before it."""
        a, b = self.snap['after'], self.snap['before']
        params = [n for kind, n in self.live if kind == 'param']
        stats = self._stat_names()
        norms = check.leaf_norms(
            {n: a['param', n] for n in params},
            {n: b['param', n] for n in params},
            {n: a['exp_avg_sq', n] for n in params}, self.n_inner,
            {n: a['buffer', n] for n in stats},
            {n: b['buffer', n] for n in stats},
            {n: b['exp_avg_sq', n] for n in params})
        return self.judged_losses, norms

    def global_batches(self, ranks: int, i: int = 0) -> list[dict]:
        """Call ``i``'s batches over every rank's rows, in rank order: what
        the ranks train on together."""
        tr, cfg = self.traffic, self.cfg
        pools = [self.pool if r == self.ctx.rank else traffic.train_pool(
            self.ctx.seed, r, tr, cfg['num_keypoints'], cfg['crop_size'],
            cfg['sigma'], self.dev) for r in range(ranks)]
        n = len(self.pool)
        rows = [(i * self.n_inner + j) % n for j in range(self.n_inner)]
        return [{k: torch.cat([p[j][k] for p in pools]) for k in pools[0][j]}
                for j in rows]

    def reference(self, batches: list[dict], low: bool = False,
                  dtype=torch.bfloat16,
                  from_window: bool = False) -> tuple[torch.Tensor, dict]:
        """The reference's losses and leaf norms after ``batches``: from
        the artifact, or with ``from_window`` from the state copied before
        the judged call of the window."""
        cfg = self.cfg
        adam, before = None, None
        if not from_window:
            model = ref_serve.load(self.ctx.weights_path(), cfg, self.dev,
                                   dtype)
        else:
            model = ref_serve.build(cfg, dtype)
            names = model.state_dict().keys()
            snap = self.snap['before']
            model.load_state_dict(
                {n: snap['param' if ('param', n) in snap else 'buffer', n]
                 for n in names}, strict=True)
            model = model.to(device=self.dev,
                             memory_format=torch.channels_last)
            adam = {n: {k: snap[k, n] for k in
                        ('exp_avg', 'exp_avg_sq', 'step')}
                    for n, _ in model.named_parameters()}
            before = {n: a['exp_avg_sq'] for n, a in adam.items()}
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        losses, opt = ref_train.run_steps(model, batches, cfg['lr'],
                                          cfg['loss_w'], low=low, adam=adam)
        params = dict(model.named_parameters())
        norms = check.leaf_norms(
            {n: p.detach() for n, p in params.items()}, start,
            {n: opt.state[p]['exp_avg_sq'] for n, p in params.items()},
            len(batches), dict(model.named_buffers()), start, before)
        return losses, norms

    def free_program(self) -> None:
        del self.steps, self.state, self.model
        harness.release()
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()


def _word(ctx, go: bool, judge: bool) -> tuple[bool, bool]:
    """Rank 0's word, given to every rank: whether the window goes on, and
    whether its next call is the judged one."""
    if ctx.world == 1:
        return go, judge
    import torch.distributed as dist
    t = torch.tensor([int(go), int(judge)], device=ctx.device)
    dist.broadcast(t, 0)
    return bool(t[0].item()), bool(t[1].item())


def _window(ctx, t: Train) -> tuple[list[float], float]:
    """Whole calls until rank 0 has seen ``ctx.seconds`` pass; the first
    call to start past ``t.pick`` of them is the judged one (a window too
    short to reach it runs one call more).  Returns each call's seconds
    and the elapsed seconds of the whole calls."""
    t0 = time.perf_counter()
    ends = [t0]
    judge = False
    while True:
        i = len(ends) - 1 + t.traffic['warm_up_calls']
        (t.judge if judge else t.call)(i)
        ends.append(time.perf_counter())
        elapsed = ends[-1] - t0
        todo = t.judged is None
        go, judge = _word(ctx, elapsed < ctx.seconds or todo,
                          todo and elapsed >= t.pick * ctx.seconds)
        if not go:
            break
    return [b - a for a, b in zip(ends, ends[1:])], ends[-1] - t0


def _gather(ctx, obj) -> list:
    """``obj`` of every rank, in rank order."""
    if ctx.world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * ctx.world
    dist.all_gather_object(out, obj)
    return out


def run(ctx) -> dict | None:
    t = Train(ctx)
    t.setup()
    setup_s = time.time() - ctx.t0
    gpu = harness.gpu_state() if ctx.rank == 0 else ''
    call_s, elapsed = _window(ctx, t)
    if ctx.rank == 0:
        gpu = f'before the window: {gpu}; after: {harness.gpu_state()}'
    calls = len(call_s)
    attempted, failed = t.attempted, t.failed
    peak = ctx.memory_peak()
    images = calls * t.n_inner * t.traffic['batch'] * ctx.world
    metrics = {'setup_s': setup_s,
               'train_images_per_s': harness.rate(images, elapsed)}
    win_losses, win_norms = t.window_record()
    layer, breakdown, busy = None, None, None
    if ctx.trace:
        layer, breakdown, busy = traced(ctx, t, calls, images / elapsed)
    first = _gather(ctx, t.norms())
    last = _gather(ctx, win_norms)
    if ctx.world > 1:
        import torch.distributed as dist
        dist.barrier()
    # the graph holds the group's collectives: it goes before the group
    t.free_program()
    if ctx.world > 1:
        dist.destroy_process_group()
    if ctx.rank != 0:
        return None
    ref_first = t.reference(t.global_batches(ctx.world))
    ref_last = t.reference(t.global_batches(ctx.world, t.judged),
                           from_window=True)
    per_rank = [{**check.train_numbers(t.first_losses, f, *ref_first),
                 **check.train_numbers(win_losses, w, *ref_last,
                                       prefix='window_')}
                for f, w in zip(first, last)]
    numbers = {k: max(r[k] for r in per_rank) for k in per_rank[0]}
    return {'metrics': metrics, 'layer': layer, 'breakdown': breakdown,
            'busy': busy, 'attempted': attempted,
            'failed': failed, 'numbers': numbers, 'peak': peak,
            'call_s': call_s, 'gpu': gpu}


def traced(ctx, t: Train, first: int, rate: float):
    """Profile ``trace_calls`` graph calls after the window on every rank;
    the readers run on rank 0's record (``rate``: the window's images/s),
    and the busy and window seconds are averaged over the ranks."""
    n = t.traffic['trace_calls']
    host_s = []
    base = first + t.traffic['warm_up_calls']
    with trace.profiled(n) as prof:
        for j in range(n + 1):
            with trace.call_range():
                losses = t.launch(base + j)
                host_s.append(t.host_s)
                t.finish(losses)
            prof.step()
    tr = trace.read(prof)
    busy = torch.tensor([tr.busy_s(), tr.window_s], dtype=torch.float64,
                        device=t.dev)
    if ctx.world > 1:
        import torch.distributed as dist
        dist.all_reduce(busy)
        busy /= ctx.world
    if ctx.rank != 0:
        return None, None, None
    steps = tr.calls * t.n_inner
    rec = SimpleNamespace(
        trace=tr, cell=ctx.cell, config=t.cfg, workload=ctx.workload,
        images=steps * t.traffic['batch'] * ctx.world, steps=steps,
        calls=tr.calls, host_call_s=host_s[1:], window_images_per_s=rate,
        chips=ctx.chips, live=SimpleNamespace(device=t.dev, config=t.cfg))
    layer = harness.layer_metrics(ctx.per_layer, rec)
    return layer, tr.breakdown(), tuple(busy.tolist())


def readings(args, wl):
    """The readings the cell's limits are set from (``readings.py``), on
    one card: for each seed the program's first call and the judged call
    of a window of ``args.seconds``; for each of ``args.control_seeds`` the
    control (the reference one precision below, in the program's place)
    and the faults planted in the reference put in the program's place:
    half of each batch left out, on several cards the exchange left out
    (rank 0's rows alone), in the window the judged call's batches left
    stale (the call before's), and a state left unchanged.  Yields (seed,
    kind, numbers)."""
    from h100_bench import run
    ranks = wl['chips']
    one = dict(wl, chips=1)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.look_seeds)):
        ctx = run.make_context(args.workload, seed, args.seconds, False,
                               'cuda', wl=one)
        t = Train(ctx)
        t.setup()
        _window(ctx, t)
        win = t.window_record()
        norms, losses = t.norms(), t.first_losses.cpu()
        t.free_program()
        first = t.global_batches(ranks)
        last = t.global_batches(ranks, t.judged)
        ref = t.reference(first)
        ref_w = t.reference(last, from_window=True)

        def both(prog_first, prog_last):
            return {**check.train_numbers(*prog_first, *ref, detail=True),
                    **check.train_numbers(*prog_last, *ref_w, detail=True,
                                          prefix='window_')}
        if seed in args.seeds and ranks == 1:
            yield seed, 'program', both((losses, norms), win)
        if seed in args.look_seeds:
            # two sound references that differ in rounding alone: bf16
            # against f32 compute, after all the steps and after one
            yield seed, 'look_f32_all', check.train_numbers(
                *t.reference(first, dtype=torch.float32), *ref, detail=True)
            yield seed, 'look_f32_first', check.train_numbers(
                *t.reference(first[:1], dtype=torch.float32),
                *t.reference(first[:1]), detail=True)
        if seed not in args.control_seeds:
            continue
        yield seed, 'control', both(
            t.reference(first, low=True),
            t.reference(last, low=True, from_window=True))

        def half(batches):
            return [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                    for b in batches]
        yield seed, 'fault_half_batch', both(
            t.reference(half(first)),
            t.reference(half(last), from_window=True))
        if ranks > 1:
            rows = wl['traffic']['batch']

            def own(batches):
                return [{k: v[:rows] for k, v in b.items()} for b in batches]
            yield seed, 'fault_no_exchange', both(
                t.reference(own(first)),
                t.reference(own(last), from_window=True))
        yield seed, 'fault_stale_batches', check.train_numbers(
            *t.reference(t.global_batches(ranks, t.judged - 1),
                         from_window=True), *ref_w, detail=True,
            prefix='window_')
        yield seed, 'fault_state_unchanged', both(
            (ref[0], _unchanged(ref[1])), (ref_w[0], _unchanged(ref_w[1])))


def _unchanged(norms: dict) -> dict:
    """The leaf norms of a call that returned its state unchanged."""
    return {'grad': norms['grad'],
            'update': {k: 0.0 for k in norms['update']},
            'stat': {k: 0.0 for k in norms['stat']}}
