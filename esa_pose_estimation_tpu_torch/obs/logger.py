"""Observability: TSV metrics logger, JSONL event log, optional TCP push.

The port's own copy of the JAX package's ``obs/logger.py`` (stdlib only;
the files it writes are byte-equal to the JAX copy's).  Re-design of the
reference's four logging channels (SURVEY §5.5):

* :class:`TsvLogger` — tab-separated metrics file with resume, API parity
  with the reference ``Logger`` (logger.py:22-98) minus the matplotlib
  coupling (plotting reads the file back, it doesn't live in the logger).
* :class:`JsonlLogger` — structured events for machine consumption (the
  modern replacement for the raw append files log/log_esa.txt).
* :class:`TcpPusher` — framed text telemetry push, protocol parity with
  tcp_send.py:9-38 (``\\runlog proname/type/classname/payload``), OFF by
  default and fail-soft like the reference (tcp_send.py:18-22).
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Iterable


class TsvLogger:
    """Append-mode TSV logger with resume (reference: logger.py:22-98)."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self.names: list[str] = []
        self.numbers: dict[str, list[float]] = {}
        if resume and os.path.exists(path):
            with open(path) as f:
                # the reference Logger writes a trailing tab after every
                # field (logger.py:52-54,63-65); strip trailing empties so
                # its files resume here unchanged
                header = f.readline().rstrip('\n')
                self.names = header.split('\t') if header else []
                while self.names and self.names[-1] == '':
                    self.names.pop()
                self.numbers = {n: [] for n in self.names}
                for line in f:
                    vals = line.rstrip('\n').split('\t')
                    while vals and vals[-1] == '':
                        vals.pop()
                    # A run killed mid-write leaves a truncated final
                    # row; skip malformed rows instead of refusing to
                    # resume (the reference's resume has the same tail
                    # tolerance by virtue of pandas-free parsing).
                    if len(vals) != len(self.names):
                        continue
                    try:
                        parsed = [float(v) for v in vals]
                    except ValueError:
                        continue
                    for n, v in zip(self.names, parsed):
                        self.numbers[n].append(v)
            # repair a truncated final row before appending: without the
            # newline the first post-resume append merges into the
            # partial line and BOTH rows are lost to every later parse
            with open(path, 'rb') as f:
                size = f.seek(0, os.SEEK_END)
                needs_nl = False
                if size:
                    f.seek(size - 1)
                    needs_nl = f.read(1) != b'\n'
            self.file = open(path, 'a')
            if needs_nl:
                self.file.write('\n')
                self.file.flush()
        else:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            self.file = open(path, 'w')

    def set_names(self, names: Iterable[str]) -> None:
        names = list(names)
        if self.names:       # resumed: keep existing header
            return
        self.names = names
        self.numbers = {n: [] for n in names}
        self.file.write('\t'.join(names) + '\n')
        self.file.flush()

    def append(self, values: Iterable) -> None:
        values = list(values)
        if len(values) != len(self.names):
            raise ValueError(f'{len(values)} values for {len(self.names)} '
                             'names')
        for n, v in zip(self.names, values):
            self.numbers[n].append(float(v))
        self.file.write('\t'.join(
            f'{v:.6f}' if isinstance(v, float) else str(v)
            for v in values) + '\n')
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class JsonlLogger:
    """One JSON object per line, timestamped."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self.file = open(path, 'a')

    def log(self, event: str, **fields) -> None:
        rec = {'ts': time.time(), 'event': event, **fields}
        self.file.write(json.dumps(rec) + '\n')
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class TcpPusher:
    """Fail-soft framed TCP telemetry (reference: tcp_send.py:9-38).

    Never raises: a dead endpoint logs False and training proceeds, same as
    the reference (tcp_send.py:18-22).  Disabled unless a host is given.
    """

    def __init__(self, host: str | None = None, port: int = 6000,
                 proname: str = 'esa_tpu'):
        self.host = host
        self.port = port
        self.proname = proname
        self.sock: socket.socket | None = None

    def create_socket(self, classname: str = 'esa') -> bool:
        if self.host is None:
            return False
        try:
            self.sock = socket.create_connection((self.host, self.port),
                                                 timeout=2.0)
            # reference handshake: announce with a timestamp on both
            # channels (tcp_send.py:23-25)
            import datetime
            now = datetime.datetime.now().strftime('%Y-%m-%d-%H-%M-%S')
            ok = self.send(now, type='log', classname=classname)
            return ok and self.send(now, type='load', classname=classname)
        except OSError:
            self.sock = None
            return False

    def send(self, data: str, type: str = 'log', classname: str = 'esa') -> bool:
        if self.sock is None:
            return False
        try:
            # Exact reference frame (tcp_send.py:29-35): '\runlog' marker,
            # then CRLF-separated key:value lines, NUL-terminated.
            frame = ('\\runlog\r\n'
                     f'proname:{self.proname}\r\n'
                     f'ltype:{type}\r\n'
                     f'classname:{classname}\r\n'
                     f'data:{data}\0')
            self.sock.sendall(frame.encode('utf-8'))
            return True
        except OSError:
            return False

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None
