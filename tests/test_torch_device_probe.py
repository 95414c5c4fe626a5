"""``utils/device_probe.py`` of the port: the probe answers within its
deadline, and a child that hangs is killed by it.

Here (no card) ``torch.cuda.device_count()`` is 0: the probe must return
0, the count this process sees, within its deadline.  The JAX probe asks
its own backend and is tested by tests/test_device_probe.py.
"""

import os
import time

import torch

from esa_pose_estimation_tpu_torch.utils import device_probe


def test_probe_reports_the_cuda_count_within_deadline():
    t0 = time.monotonic()
    n = device_probe.cuda_device_count(timeout_s=60.0)
    assert n == torch.cuda.device_count() == 0
    assert time.monotonic() - t0 < 60.0


def test_hanging_child_is_killed_at_the_deadline(monkeypatch, tmp_path):
    pid_file = tmp_path / 'pid'
    monkeypatch.setattr(
        device_probe, '_PROBE_CODE',
        f"import os, time; open({str(pid_file)!r}, 'w').write("
        f"str(os.getpid())); time.sleep(600)  # {{out!r}}")
    t0 = time.monotonic()
    assert device_probe.cuda_device_count(timeout_s=2.0) is None
    assert time.monotonic() - t0 < 10.0
    pid = int(pid_file.read_text())
    try:                                  # reaped: no such process
        os.kill(pid, 0)
        alive = True
    except ProcessLookupError:
        alive = False
    assert not alive


def test_await_gives_up_by_its_deadline(monkeypatch):
    monkeypatch.setattr(device_probe, '_PROBE_CODE',
                        'import time; time.sleep(600)  # {out!r}')
    t0 = time.monotonic()
    assert device_probe.await_cuda(total_deadline_s=3.0, probe_timeout_s=1.0,
                                   retry_interval_s=1.0,
                                   verbose=False) is None
    assert time.monotonic() - t0 < 15.0
