"""The readings a cell's correctness limits are set from, on the card at
the cell's own size, in one process:

    python3 h100_bench/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3] [--look-seeds 1] [--seconds 3]

For each of ``--seeds`` the program runs a short window of ``--seconds``
at the cell's load and its numbers are read as a run reads them; for each
of ``--control-seeds`` the control is read (the reference one precision
below the configuration's in the program's place) and, for training, the
faults planted in the reference put in the program's place.  The cell's
driver says what it reads (its ``readings``).  One JSON line per reading.
A cell on several cards reads the control and the faults in one process
on one card (they are the reference's), and the program's own readings
come from its runs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

if __package__ in (None, ''):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import harness, run  # noqa: E402


def _line(seed: int, kind: str, numbers: dict) -> None:
    print(json.dumps({'seed': seed, 'kind': kind, 'numbers': numbers}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--look-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    run._environment()
    wl = harness.workload(args.workload)
    driver = importlib.import_module(f'h100_bench.drivers.{wl["driver"]}')
    for seed, kind, numbers in driver.readings(args, wl):
        _line(seed, kind, numbers)
    return 0


if __name__ == '__main__':
    sys.exit(main())
