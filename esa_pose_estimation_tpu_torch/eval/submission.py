"""SPEED competition submission writer.

The port's own copy of the JAX package's ``eval/submission.py`` (stdlib
and numpy): for the same results it writes the same CSV, byte for byte.
API-compatible re-implementation of the starter-kit ``SubmissionWriter``
(reference: submission.py:6-52): collects per-image pose estimates for the
synthetic test and real test partitions and exports the leaderboard CSV
(filename, q_wxyz, t_xyz), sorted by filename, test before real_test.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime

import numpy as np


class SubmissionWriter:
    """Collects results and exports a submission CSV."""

    def __init__(self):
        self.test_results: list[dict] = []
        self.real_test_results: list[dict] = []

    def _append(self, filename: str, q, r, real: bool) -> None:
        entry = {'filename': filename,
                 'q': [float(v) for v in np.asarray(q).reshape(-1)],
                 'r': [float(v) for v in np.asarray(r).reshape(-1)]}
        (self.real_test_results if real else self.test_results).append(entry)

    def append_test(self, filename: str, q, r) -> None:
        self._append(filename, q, r, real=False)

    def append_real_test(self, filename: str, q, r) -> None:
        self._append(filename, q, r, real=True)

    def append_batch(self, filenames, quats, trans, real: bool = False) -> None:
        """Batched append for device-produced results (one host sync per
        batch instead of per image)."""
        quats = np.asarray(quats)
        trans = np.asarray(trans)
        for name, q, t in zip(filenames, quats, trans):
            self._append(name, q, t, real=real)

    def export(self, out_dir: str = '', suffix: str | None = None) -> str:
        sorted_test = sorted(self.test_results, key=lambda k: k['filename'])
        sorted_real = sorted(self.real_test_results,
                             key=lambda k: k['filename'])
        if suffix is None:
            suffix = datetime.now().strftime('%Y%m%d-%H%M')
        if out_dir:
            # don't lose a full inference sweep to a missing directory
            os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f'submission_{suffix}.csv')
        with open(path, 'w') as f:
            writer = csv.writer(f, lineterminator='\n')
            for result in sorted_test + sorted_real:
                writer.writerow([result['filename'],
                                 *(result['q'] + result['r'])])
        return path
