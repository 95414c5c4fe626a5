"""``serve_closed``'s run and readings for any subclass of its ``Serve``:
the drivers that change what a call is or how it is judged
(``serve_hrformer``, ``serve_host``) subclass ``Serve`` and hand the class
here, rather than copying the loop."""

from __future__ import annotations

import time

from h100_bench import harness
from h100_bench.drivers import serve_closed


def run(ctx, serve_cls) -> dict:
    """One run of the cell with ``serve_cls(ctx)`` as the program: set-up,
    the window (calls sent ahead where the traffic says), the traced calls
    with ``--trace 1``, then the program freed and its kept rows judged."""
    s = serve_cls(ctx)
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
        layer, breakdown, busy = serve_closed.traced(
            ctx, s, win.calls, metrics['serve_images_per_s'])
    s.free_program()
    numbers = s.numbers()
    return {'metrics': metrics, 'layer': layer, 'breakdown': breakdown,
            'busy': busy, 'attempted': attempted, 'failed': failed,
            'numbers': numbers, 'peak': peak, 'call_s': win.latencies(),
            'gpu': gpu}


def readings(args, serve_cls):
    """The readings the cell's limits are set from (``readings.py``), as
    ``serve_closed.readings`` takes them, with ``serve_cls`` as the
    program."""
    from h100_bench import run as run_mod
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        s = serve_cls(run_mod.make_context(args.workload, seed,
                                           args.seconds, False, 'cuda'))
        s.setup()
        harness.Window(args.seconds).run(s.call)
        s.free_program()
        if seed in args.seeds:
            yield seed, 'program', s.numbers(detail=True)
        if seed in args.control_seeds:
            yield seed, 'control', s.numbers(control=True, detail=True)
