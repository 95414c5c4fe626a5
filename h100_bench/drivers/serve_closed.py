"""Closed-loop serving through ``pipeline.make_jitted_pipeline``: one
caller hands ``traffic.batch`` frames and their boxes to a call, waits
for the poses on the host, then sends the next batch.  With
``traffic.ahead_calls`` the caller keeps that many calls sent ahead of
the one whose poses it waits for (an offline scorer's pipeline), so a
stall of the host does not leave the card idle.

Frames come from a pool of ``traffic.pool_frames`` distinct uint8 frames
rendered on the card from the seed, taken in turn, so a call never reads
the frames of the call before it; the RANSAC uniforms are drawn by the
harness for each call and handed in.  For the check after the window,
``check_frames`` rows of the outputs are kept by reservoir sampling over
``keep_per_call`` seed-drawn positions of every call, in buffers made in
set-up (the window allocates nothing for them).
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from h100_bench import check, harness, trace, traffic
from h100_bench.reference import serve as ref_serve

FIELDS = ('heatmaps', 'keypoints_2d', 'confidences', 'R', 'trans')


class Serve:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.config, ctx.workload[
            'traffic']
        self.dev = ctx.device
        self.batch = self.traffic['batch']
        self.attempted = self.failed = 0
        self.host_calls: list[float] = []
        self.seen = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from esa_pose_estimation_tpu_torch import pipeline
        cfg, tr, dev, seed = self.cfg, self.traffic, self.dev, self.ctx.seed
        k = cfg['num_keypoints']
        self.model = self.ctx.program_model()
        self.pool = traffic.frame_pool(seed, tr, k, dev)
        if tr['pool_frames'] % self.batch:
            raise ValueError('pool_frames must be a multiple of batch')
        self.pts = traffic.points_3d(k, dev)
        s = cfg['serving']
        self.serve = pipeline.make_jitted_pipeline(
            self.model, self.pts, crop_size=cfg['crop_size'],
            conf_threshold=s['conf_threshold'],
            min_keypoints=s['min_keypoints'],
            n_hypotheses=s['n_hypotheses'], sample_size=s['sample_size'],
            lm_iters=s['lm_iters'])
        self.ugen = traffic.generator(dev, seed, 'uniforms')
        self.rng = random.Random(traffic.stream_seed(seed, 'keep'))
        for i in range(tr['warm_up_calls']):
            self.call(i, keep=False)
        n = tr['check_frames']
        _, u, out = self.launch(0)
        self.kept = {f: torch.empty((n,) + getattr(out, f).shape[1:],
                                    dtype=getattr(out, f).dtype, device=dev)
                     for f in FIELDS}
        self.kept_u = torch.empty((n,) + u.shape[1:], dtype=u.dtype,
                                  device=dev)
        self.kept_frame = [0] * n
        # where the poses of the calls sent ahead land on the host
        self.ahead = tr.get('ahead_calls', 0)
        qt = torch.cat([out.quat, out.trans], -1)
        cuda = dev.type == 'cuda'
        self.ring = [(torch.empty(qt.shape, dtype=qt.dtype, pin_memory=cuda),
                      torch.cuda.Event() if cuda else None)
                     for _ in range(self.ahead + 1)]
        self.attempted = self.failed = 0
        self.host_calls = []
        harness.steady()

    # -- one call -------------------------------------------------------
    def draw(self) -> torch.Tensor:
        s = self.cfg['serving']
        return torch.rand((self.batch, s['n_hypotheses'],
                           self.cfg['num_keypoints']), generator=self.ugen,
                          device=self.dev)

    def launch(self, i: int):
        start = (i * self.batch) % self.traffic['pool_frames']
        u = self.draw()
        ts = time.perf_counter()
        out = self.serve(self.pool.frames[start:start + self.batch],
                         self.pool.boxes[start:start + self.batch],
                         ransac_uniforms=u)
        self.host_s = time.perf_counter() - ts
        return start, u, out

    def finish(self, i: int, start: int, u, out, keep: bool) -> None:
        if keep:
            self.keep(start, u, out)
        qt = torch.cat([out.quat, out.trans], -1).cpu()
        self.attempted += qt.shape[0]
        self.failed += int((~torch.isfinite(qt).all(-1)).sum())

    def keep(self, start: int, u, out) -> None:
        """Reservoir sampling: each candidate row ends in the kept sample
        with the same chance, whatever the number of calls."""
        n = len(self.kept_frame)
        for pos in self.rng.sample(range(self.batch),
                                   self.traffic['keep_per_call']):
            slot = self.seen if self.seen < n else self.rng.randrange(
                self.seen + 1)
            self.seen += 1
            if slot >= n:
                continue
            for f in FIELDS:
                self.kept[f][slot].copy_(getattr(out, f)[pos])
            self.kept_u[slot].copy_(u[pos])
            self.kept_frame[slot] = start + pos

    def call(self, i: int, keep: bool = True) -> None:
        start, u, out = self.launch(i)
        self.host_calls.append(self.host_s)
        self.finish(i, start, u, out, keep)

    def send(self, i: int):
        """Call ``i`` sent ahead: its kept rows and its poses are copied
        out on the card's stream before the next call is sent, and its
        outputs dropped.  Returns the host buffer and the event that
        marks the poses' arrival."""
        start, u, out = self.launch(i)
        self.host_calls.append(self.host_s)
        self.keep(start, u, out)
        host, done = self.ring[i % len(self.ring)]
        host.copy_(torch.cat([out.quat, out.trans], -1),
                   non_blocking=done is not None)
        if done is not None:
            done.record()
        return host, done

    def wait(self, sent) -> None:
        host, done = sent
        if done is not None:
            done.synchronize()
        self.attempted += host.shape[0]
        self.failed += int((~torch.isfinite(host).all(-1)).sum())

    # -- the check ------------------------------------------------------
    def sample(self):
        """The kept rows (outputs, uniforms) and their frames' indices."""
        n = min(self.seen, len(self.kept_frame))
        out = {f: v[:n] for f, v in self.kept.items()}
        idx = torch.tensor(self.kept_frame[:n], device=self.dev)
        return out, self.kept_u[:n], idx

    def free_program(self) -> None:
        del self.serve, self.model
        harness.release()
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False, detail: bool = False) -> dict:
        """The check's numbers on the sampled rows (with ``control`` the
        control's outputs in the program's place)."""
        out, u, idx = self.sample()
        frames = self.pool.frames.index_select(0, idx)
        boxes = self.pool.boxes.index_select(0, idx)
        ref = ref_serve.load(self.ctx.weights_path(), self.cfg,
                             self.dev).eval()
        if control:
            out = check.control_outputs(ref, frames, boxes, u, self.pts,
                                        self.cfg)
        return check.serve_numbers(ref, frames, boxes, u, out, self.pts,
                                   self.cfg, detail=detail)


def run(ctx) -> dict:
    s = Serve(ctx)
    s.setup()
    setup_s = time.time() - ctx.t0
    gpu = harness.gpu_state()
    win = harness.Window(ctx.seconds)
    if s.ahead:
        win.run_ahead(s.send, s.wait, s.ahead)
    else:
        win.run(s.call)
    gpu = f'before the window: {gpu}; after: {harness.gpu_state()}'
    attempted, failed = s.attempted, s.failed
    peak = ctx.memory_peak()
    metrics = {'setup_s': setup_s,
               'serve_images_per_s': harness.rate(attempted, win.elapsed),
               'serve_p95_ms': harness.p95(win.latencies()) * 1e3}
    layer, breakdown, busy = None, None, None
    if ctx.trace:
        layer, breakdown, busy = traced(ctx, s, win.calls,
                                        metrics['serve_images_per_s'])
    s.free_program()
    numbers = s.numbers()
    return {'metrics': metrics, 'layer': layer, 'breakdown': breakdown,
            'busy': busy, 'attempted': attempted, 'failed': failed,
            'numbers': numbers, 'peak': peak, 'call_s': win.latencies(),
            'gpu': gpu}


def traced(ctx, s: Serve, first: int, rate: float):
    """Profile ``trace_calls`` calls after the window; the per-layer
    readers run on their record with the live program at hand.  The host
    time of a call and the rate (``rate``, images/s) are the window's: the
    tracer stretches a replay."""
    n = s.traffic['trace_calls']
    host_s = list(s.host_calls)
    with trace.profiled(n) as prof:
        for j in range(n + 1):
            i = first + j
            with trace.call_range():
                start, u, out = s.launch(i)
                s.finish(i, start, u, out, keep=False)
            prof.step()
    tr = trace.read(prof)
    rec = SimpleNamespace(
        trace=tr, cell=ctx.cell, config=s.cfg, workload=ctx.workload,
        images=tr.calls * s.batch, steps=tr.calls, calls=tr.calls,
        host_call_s=host_s, window_images_per_s=rate, chips=ctx.chips,
        live=SimpleNamespace(model=s.model, pts=s.pts, batch=s.batch,
                             device=s.dev, last=out, uniforms=u,
                             config=s.cfg))
    layer = harness.layer_metrics(ctx.per_layer, rec)
    return layer, tr.breakdown(), (tr.busy_s(), tr.window_s)


def readings(args, wl):
    """The readings the cell's limits are set from (``readings.py``): for
    each of ``args.seeds`` the program's numbers after a short window at
    the cell's load, for each of ``args.control_seeds`` the control's.
    Yields (seed, kind, numbers)."""
    from h100_bench import run
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        s = Serve(run.make_context(args.workload, seed, args.seconds, False,
                                   'cuda'))
        s.setup()
        harness.Window(args.seconds).run(s.call)
        s.free_program()
        if seed in args.seeds:
            yield seed, 'program', s.numbers(detail=True)
        if seed in args.control_seeds:
            yield seed, 'control', s.numbers(control=True, detail=True)
