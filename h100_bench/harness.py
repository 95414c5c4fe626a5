"""What every cell's run shares: the cell's files found by name, the
measured window, the host-clock statistics, the per-layer readers, the
device record and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``, one
per kind of traffic), and ``BENCHMARK.json`` names the metrics it reports.
A per-layer metric ``m`` is ``layer_metrics/<m>.py``, whose ``read(rec)``
returns a number or None (nothing to read: the metric is left out of the
line).  Adding a cell, a configuration or a metric adds files and edits
none.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the top-level modules no process of the benchmark may hold: JAX and the
# JAX package, compared by the whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'esa_pose_estimation_tpu')
PROGRAM = 'esa_pose_estimation_tpu_torch'


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux's
    ``/proc``); where that cannot be read, now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf('SC_CLK_TCK')
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / 'BENCHMARK.json')


def workload(name: str) -> dict:
    return load_json(HERE / 'workloads' / f'{name}.json')


def config(name: str) -> dict:
    return load_json(HERE / 'configs' / f'{name}.json')


def metrics_of(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics ``cell`` reports: those
    that list it (an end-to-end metric that lists no cells, every cell's;
    each per-layer metric lists its cells)."""
    e2e = [m for m in bench['end_to_end']
           if cell in m.get('workloads', [cell])]
    per_layer = [m for m in bench['per_layer'] if cell in m['workloads']]
    return e2e, per_layer


def forbidden_modules(modules=None) -> list[str]:
    """The entries of ``sys.modules`` whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split('.', 1)[0] in FORBIDDEN})


def program_is_local() -> bool:
    """Whether the program is importable from this checkout itself (and
    not from an installation elsewhere)."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        return False
    return Path(spec.origin).resolve().is_relative_to(ROOT)


def reader(metric: str):
    """``layer_metrics/<metric>.py``'s ``read``."""
    path = HERE / 'layer_metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'h100_bench.layer_metrics.{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the measured window

def steady() -> None:
    """The end of set-up: what set-up made is collected once and frozen
    out of the garbage collector's later passes, so a pass in the window
    does not walk it."""
    gc.collect()
    gc.freeze()


def release() -> None:
    """After the window: what set-up froze is collected again, so the
    program's objects that were dropped (its graphs among them) are
    freed, cycles too."""
    gc.unfreeze()
    gc.collect()


def gpu_state() -> str:
    """The cards' clocks, power, temperature and throttle reasons now, as
    ``nvidia-smi`` reads them (a note on standard error beside each run)."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=index,clocks.sm,clocks.max.sm,'
             'power.draw,power.limit,temperature.gpu,'
             'clocks_throttle_reasons.active', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not available'


class Window:
    """Whole calls back to back until ``seconds`` have passed: each call's
    host-clock span from its hand-over to its results on the host, and the
    window from the first call's start to the last call's end.  No call
    is cut."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.starts: list[float] = []
        self.ends: list[float] = []

    def run(self, call) -> None:
        """``call(i)`` for i = 0, 1, ... until the window is over; each
        call returns once its results are on the host."""
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            call(i)
            te = time.perf_counter()
            self.starts.append(ts)
            self.ends.append(te)
            i += 1
            if te - t0 >= self.seconds:
                break

    def run_ahead(self, send, wait, depth: int) -> None:
        """``send(i)`` for i = 0, 1, ... with up to ``depth`` calls sent
        ahead of the one waited for (``wait(handle)`` returns once that
        call's results are on the host), so the card is fed while the
        host stands still.  Once the time is up nothing more is sent, all
        that was sent is waited for, in order, and the last wait's end
        closes the window: every call counts, over all of its time."""
        t0 = time.perf_counter()
        pending = []
        i = 0
        while True:
            if not i or time.perf_counter() - t0 < self.seconds:
                self.starts.append(time.perf_counter())
                pending.append(send(i))
                i += 1
                if len(pending) <= depth:
                    continue
            elif not pending:
                break
            wait(pending.pop(0))
            self.ends.append(time.perf_counter())

    @property
    def calls(self) -> int:
        return len(self.starts)

    @property
    def elapsed(self) -> float:
        return self.ends[-1] - self.starts[0]

    def latencies(self) -> list[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]


def rate(items: int, elapsed: float) -> float:
    """Items completed over the elapsed time of the whole calls."""
    return items / elapsed


def p95(values: list[float]) -> float:
    """The 95th percentile of all ``values`` (linear between the closest
    ranks, numpy's default)."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the result

def device_record(kind: str, count: int, peak_bytes: int) -> dict:
    return {'platform': 'gpu', 'kind': kind, 'count': count,
            'memory_peak_bytes': int(peak_bytes)}


def comparisons_text(numbers: dict) -> str:
    """The numbers compared, each beside its limit, one per line."""
    return '\n'.join(f'check {k}: {v["value"]!r} limit {v["limit"]!r}'
                     f' {"ok" if v["ok"] else "FAILED"}'
                     for k, v in numbers.items())


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, numbers: dict, breakdown=None) -> str:
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['check'] = {k: {'value': v['value'], 'limit': v['limit']}
                    for k, v in numbers.items()}
    return json.dumps(out)


def layer_metrics(per_layer: list[dict], rec) -> dict:
    """Each per-layer metric the cell reports that its reader finds."""
    out = {}
    for m in per_layer:
        value = reader(m['name'])(rec)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out
