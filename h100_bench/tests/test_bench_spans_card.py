"""The program's recorder on the card (skips without one), at the cells'
own sizes:

* each profiled batch-256 call's ``peak_decode_kernel`` lies inside that
  call's ``decode`` stage, on the profiler's clock, within 20 µs;
* a call's lead (entry stamp to first stage), stages and tail (last
  stage to exit stamp) add up to its [entry, exit] span within 2%;
* with ``recording(False)`` a batch-1 replay runs no stamp kernel, and
  with it on exactly the stamps the call holds more;
* ``b256_network_ms`` lies within 10% of ``hrnet_ms`` in a traced run of
  the cell, and ``b1_ransac_ms`` within 25% of ``ransac_ms`` (the median
  of three readings) after a window of the cell's traffic: the
  harness's graph chains 20 calls of one layer on its own input, the
  program's stage is one call inside the served graph.

The readings are printed (``-s``)::

    python3 -m pytest h100_bench/tests/test_bench_spans_card.py -q -s
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

import pytest
import torch

from h100_bench import harness, run

SEED = 2**31 + 17
STAMP = 'stamp_kernel'
K1 = 'peak_decode_kernel'


def _serve(cell: str, warm_up_calls: int = 2):
    from h100_bench.drivers.serve_closed import Serve
    wl = harness.workload(cell)
    wl['traffic']['warm_up_calls'] = warm_up_calls
    s = Serve(run.make_context(cell, SEED, 2.0, False, 'cuda', wl=wl))
    s.setup()
    return s


def _profiled(s, first: int, n: int) -> list[dict]:
    """``n`` calls under the profiler; its device kernels, (name, start
    ns, end ns) on its clock."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            start, u, out = s.launch(i)
            s.finish(i, start, u, out, keep=False)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = trace['baseTimeNanoseconds']
    return [(e['name'], base + float(e['ts']) * 1e3,
             base + (float(e['ts']) + float(e['dur'])) * 1e3)
            for e in trace['traceEvents']
            if e.get('cat') == 'kernel' and 'dur' in e]


def _stage(call, name):
    stamps = dict(call.stamps)
    return stamps[name], stamps['/' + name]


@pytest.mark.card
def test_decode_kernel_inside_its_stage_and_stages_fill_the_call(card):
    from esa_pose_estimation_tpu_torch.obs import profiling
    s = _serve('serve_offline_b256')
    for i in range(5):
        s.call(i, keep=False)
    profiling.recorder().calibrate()
    traced = _profiled(s, 5, 3)
    kernels = [k for k in traced if K1 in k[0]]
    stamps = [k for k in traced if STAMP in k[0]]
    calls = profiling.recorder().calls()
    graph = calls[-1].graph
    calls = [c for c in calls if c.graph == graph]
    assert len(kernels) == 3
    worst, margins = 0.0, []
    for (_, k0, k1), c in zip(kernels, calls[-3:]):
        d0, d1 = _stage(c, 'decode')
        worst = max(worst, d0 - k0, k1 - d1)
        margins.append((round((k0 - d0) / 1e3, 2), round((d1 - k1) / 1e3, 2)))
    # the stamps against the profiler's own record of the stamp kernels
    ours = [t for c in calls[-3:] for _, t in c.stamps]
    apart = [round((t - k[1]) / 1e3, 1) for t, k in zip(ours, stamps)]
    ring = next(r for r in profiling.recorder().rings.values() if r.cuda)
    print(f'# K1 inside decode: worst overrun {worst / 1e3:.2f} us; K1 after '
          f'the stage begins and before it ends, us: {margins}; each stamp '
          f'less the profiler\'s stamp kernel, us: {apart}; calibration '
          f'errors, us: {[p[2] / 1e3 for p in ring.points]}')
    assert len(stamps) == len(ours)
    assert worst < 20e3
    rows = []
    for c in calls[-8:]:
        ns = profiling.stage_ns(c)
        lead = c.stamps[1][1] - c.entry
        tail = c.exit - c.stamps[-2][1]
        total = lead + sum(sum(v) for v in ns.values()) + tail
        rows.append((c.exit - c.entry - total) / (c.exit - c.entry))
        assert abs(rows[-1]) < 0.02, (c.seq, ns, lead, tail)
    print(f'# stages against the call: {[f"{r:.5f}" for r in rows]}')
    del s


@pytest.mark.card
def test_recording_off_replays_no_stamp(card):
    from esa_pose_estimation_tpu_torch.obs import profiling
    s = _serve('serve_online_b1')
    per_call = {}
    for on in (False, True):
        with profiling.recording(on):
            for i in range(3):
                s.call(i, keep=False)
            kernels = _profiled(s, 3, 2)
            per_call[on] = (len(kernels) / 2,
                            sum(STAMP in k[0] for k in kernels) / 2)
    calls = profiling.recorder().calls()
    stamps = len(calls[-1].stamps)
    print(f'# kernels a batch-1 call, stamps: off {per_call[False]}, '
          f'on {per_call[True]}; a call holds {stamps} stamps')
    assert per_call[False][1] == 0
    assert per_call[True][1] == stamps
    assert per_call[True][0] - per_call[False][0] == stamps
    del s


def _traced(cell: str) -> dict:
    out = subprocess.run(
        [sys.executable, str(harness.HERE / 'run.py'), '--workload', cell,
         '--seed', str(SEED), '--seconds', '5', '--trace', '1'],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'], line
    return {k: v['value'] for k, v in line['metrics'].items()}


@pytest.mark.card
def test_network_stage_agrees_with_hrnet_ms(card):
    b256 = _traced('serve_offline_b256')
    print(f'# serve_offline_b256: {json.dumps(b256)}')
    assert abs(b256['b256_network_ms'] / b256['hrnet_ms'] - 1) < 0.10


@pytest.mark.card
def test_ransac_stage_agrees_with_ransac_ms(card):
    """The stage's median over a 5 s window of the cell's traffic against
    the median of three readings of ``ransac_ms`` on the last call: one
    reading (20 chained calls in one graph) has read 8.5 to 11.5 ms on
    the same frame in different runs."""
    from types import SimpleNamespace

    from h100_bench.layer_metrics import _spans
    s = _serve('serve_online_b1', harness.workload(
        'serve_online_b1')['traffic']['warm_up_calls'])
    s.host_calls = []
    harness.Window(5.0).run(s.call)
    _, u, out = s.launch(0)
    rec = SimpleNamespace(
        workload=harness.workload('serve_online_b1'), config=s.cfg,
        host_call_s=s.host_calls,
        live=SimpleNamespace(last=out, uniforms=u, pts=s.pts, device=s.dev,
                             config=s.cfg))
    rec.workload['traffic']['trace_calls'] = 0   # the one call after
    stage = _spans.stage_ms(rec, 'ransac_epnp')
    outside = [harness.reader('ransac_ms')(rec) for _ in range(3)]
    print(f'# b1_ransac_ms {stage:.4f}, ransac_ms {outside}')
    assert abs(stage / statistics.median(outside) - 1) < 0.25
    del s
