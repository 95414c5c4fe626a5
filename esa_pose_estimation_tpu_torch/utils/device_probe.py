"""Probing the CUDA devices with a deadline (torch port of the JAX
package's ``utils/device_probe.py``).

A driver or a card in a bad state can make the first CUDA call in a
process hang instead of raise.  :func:`cuda_device_count` asks a child
process for ``torch.cuda.device_count()``, waits for it up to a deadline,
then kills the child's whole process group; a hang, a crash or an
unreadable answer gives ``None``.  The child writes its count to a file,
not a pipe: a helper process that inherits the pipe would keep a read
blocked after the child is killed.

The probe only reports.  No entry point uses it to carry on on the CPU:
the commands still ask for ``cuda`` and raise without it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time

# the child's program; ``{out!r}`` is the file it writes the count to
_PROBE_CODE = ("import torch; open({out!r}, 'w').write("
               "str(torch.cuda.device_count()))")


def cuda_device_count(timeout_s: float = 60.0) -> int | None:
    """``torch.cuda.device_count()`` of a child process, or None if it did
    not answer within ``timeout_s`` seconds."""
    with tempfile.NamedTemporaryFile('r', suffix='.txt', delete=False) as f:
        out_path = f.name
    proc = subprocess.Popen(
        [sys.executable, '-c', _PROBE_CODE.format(out=out_path)],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    deadline = time.monotonic() + timeout_s
    try:
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        if proc.poll() is None or proc.returncode != 0:
            return None
        with open(out_path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None
    finally:
        # sweep the group: helpers can outlive a child that exited, and a
        # killed child must be reaped
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
        try:
            os.unlink(out_path)
        except OSError:
            pass


def await_cuda(total_deadline_s: float = 900.0, probe_timeout_s: float = 60.0,
               retry_interval_s: float = 30.0,
               verbose: bool = True) -> int | None:
    """Probe again every ``retry_interval_s`` until a probe answers;
    None once ``total_deadline_s`` has passed without an answer."""
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        n = cuda_device_count(probe_timeout_s)
        if n is not None:
            return n
        elapsed = time.monotonic() - start
        if elapsed + retry_interval_s >= total_deadline_s:
            return None
        if verbose:
            print(f'# CUDA probe unanswered (probe {attempt}, '
                  f'{elapsed:.0f}s elapsed); retrying in '
                  f'{retry_interval_s:.0f}s', flush=True)
        time.sleep(retry_interval_s)
