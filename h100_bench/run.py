"""The benchmark of esa_pose_estimation_tpu_torch on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

One cell, one run, from the root of a checkout: set-up (the program's
weights, the cell's inputs made on the card from the seed, every shape
warmed up and captured), a measured window of whole calls, with
``--trace 1`` a few profiled calls read by the cell's per-layer metrics,
then the check against the plain reference (``check.py``).  The numbers
compared go to standard error, each beside its limit, as its last lines;
the result is the last line of standard output, one JSON object.

A cell on several cards starts one process per card: this one is rank 0
and starts the others with ``--rank`` and a free local ``--port``, waits
for them, and alone prints the result.

Exit codes: 2 without the cards the cell asks for, 3 where the program is
not importable from this checkout, 4 where JAX or the JAX package was
loaded; an error inside a run raises (1).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

if __package__ in (None, ''):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import harness  # noqa: E402

T0 = harness.process_start()


def _environment() -> None:
    """Caches at fixed places inside the checkout; no library loads JAX."""
    os.environ['TRITON_CACHE_DIR'] = str(harness.HERE / '.cache' / 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rank', type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument('--port', type=int, default=0, help=argparse.SUPPRESS)
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 device, rank: int = 0, port: int = 0, wl: dict | None = None,
                 cfg: dict | None = None):
    """Everything a driver reads about its run.  ``wl`` and ``cfg``
    replace the cell's files (the harness's CPU tests)."""
    import torch
    bench = harness.benchmark()
    wl = wl or harness.workload(workload)
    cfg = cfg or harness.config(wl['config'])
    e2e, per_layer = harness.metrics_of(bench, workload)
    world = wl['chips']
    dev = torch.device(device if device != 'cuda'
                       else f'cuda:{rank % max(torch.cuda.device_count(), 1)}')

    def weights_path() -> str:
        return str(harness.ROOT / cfg['weights'])

    def program_model(train: bool = False):
        from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
        from esa_pose_estimation_tpu_torch.utils import config as pcfg
        from esa_pose_estimation_tpu_torch.utils.artifact import (
            from_jax_variables,
            load_hrnet_artifact,
            read_artifact,
        )
        model_cfg = getattr(pcfg, cfg['model'])()
        if not train:
            return load_hrnet_artifact(weights_path(), cfg=model_cfg,
                                       dtype=torch.bfloat16, device=dev)
        variables, _ = read_artifact(weights_path())
        model = HRNet(model_cfg, dtype=torch.bfloat16)
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return model.to(dev, memory_format=torch.channels_last)

    def memory_peak() -> int:
        if dev.type != 'cuda':
            return 0
        peak = torch.tensor([torch.cuda.max_memory_allocated(dev)],
                            device=dev)
        if world > 1:
            import torch.distributed as dist
            dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        return int(peak.item())

    return SimpleNamespace(
        cell=workload, seed=seed, seconds=seconds, trace=trace, device=dev,
        rank=rank, world=world, port=port, chips=world, workload=wl,
        config=cfg, end_to_end=e2e, per_layer=per_layer, t0=T0,
        weights_path=weights_path, program_model=program_model,
        memory_peak=memory_peak)


def run_cell(ctx) -> dict | None:
    """The cell's traffic loop (``drivers/<driver>.py``), then the result's
    parts (rank 0)."""
    import importlib
    driver = importlib.import_module(
        f'h100_bench.drivers.{ctx.workload["driver"]}')
    out = driver.run(ctx)
    if out is None:
        return None
    out['metrics'] = {m['name']: {'value': float(out['metrics'][m['name']]),
                                  'unit': m['unit']}
                      for m in ctx.end_to_end}
    from h100_bench import check
    out['judged'] = check.judge(out['numbers'], ctx.workload['limits'])
    out['correct'] = all(v['ok'] for v in out['judged'].values())
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _environment()
    wl = harness.workload(args.workload)
    import torch
    chips = wl['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    if not harness.program_is_local():
        print(f'{harness.PROGRAM} is not importable from {harness.ROOT}',
              file=sys.stderr)
        return 3
    # the port's CUDA kernels, built on a checkout's first run and loaded
    # after: set-up work, timed here so that a build shows apart
    from esa_pose_estimation_tpu_torch import _build
    build_s = _build.build_all()
    children = []
    port = args.port
    if chips > 1 and args.rank == 0:
        port = _free_port()
        base = [sys.executable, str(Path(__file__).resolve()),
                '--workload', args.workload, '--seed', str(args.seed),
                '--seconds', str(args.seconds), '--trace', str(args.trace),
                '--port', str(port)]
        children = [subprocess.Popen(base + ['--rank', str(r)])
                    for r in range(1, chips)]
    try:
        ctx = make_context(args.workload, args.seed, args.seconds,
                           bool(args.trace), 'cuda', args.rank, port)
        out = run_cell(ctx)
    except BaseException:
        for c in children:      # they would wait on this rank for ever
            c.kill()
        raise
    finally:
        codes = [c.wait() for c in children]
    if args.rank != 0:
        return 0
    if any(codes):
        print(f'a rank failed: exit codes {codes}', file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 4
    device = harness.device_record(torch.cuda.get_device_name(ctx.device),
                                   chips, out['peak'])
    metrics = out['metrics']
    breakdown = None
    if args.trace:
        metrics = out['layer']
        busy, window = out['busy']
        device['busy_s'], device['window_s'] = busy, window
        breakdown = out['breakdown']
    xs = sorted(out['call_s'])
    print(f'# {args.workload}: {len(xs)} calls of {xs[0]:.6f} to '
          f'{xs[-1]:.6f} s (median {xs[len(xs) // 2]:.6f}), peak '
          f'{out["peak"]} bytes, {device["kind"]}; {out["gpu"]}',
          file=sys.stderr)
    print(f'# setup_s {out["metrics"]["setup_s"]["value"]:.3f} s, of which '
          f'{build_s:.3f} s building or loading the CUDA kernels',
          file=sys.stderr)
    print(harness.comparisons_text(out['judged']), file=sys.stderr)
    print(harness.result_line(out['correct'], out['attempted'],
                              out['failed'], metrics, device, out['judged'],
                              breakdown))
    return 0


if __name__ == '__main__':
    sys.exit(main())
