"""Closed-loop serving of frames held in host memory: ``serve_closed``'s
traffic loop (run by ``_closed_loop``), where each call's frames and boxes
come from pageable host memory, as a command's decoded batches do
(``cli/submit``, ``cli/evaluate``), and reach the card through the
program's ``data/speed.to_device`` (pinned, then copied without blocking
the host) before the serving graph.

The pool is rendered on the card from the seed, as ``serve_closed``'s is,
then moved once in set-up to numpy arrays in pageable host memory (uint8
frames, f32 boxes); the card's copy is freed and the peak memory counted
from there.  Calls take the pool's frames in turn.  The check reads the
kept rows' frames back from the host arrays and judges them as
``serve_closed`` does."""

from __future__ import annotations

import time

import torch

from h100_bench import check, harness
from h100_bench.drivers import _closed_loop, serve_closed
from h100_bench.reference import serve as ref_serve


class ServeHost(serve_closed.Serve):
    """``serve_closed.Serve`` whose calls hand host arrays to
    ``data/speed.to_device``."""

    host = None              # (frames, boxes) numpy arrays

    def setup(self) -> None:
        super().setup()      # its first call moves the pool to the host
        self.pool = self.pool._replace(frames=None)
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        harness.steady()

    def launch(self, i: int):
        from esa_pose_estimation_tpu_torch.data.speed import to_device
        if self.host is None:
            self.host = (self.pool.frames.cpu().numpy(),
                         self.pool.boxes.cpu().numpy())
        start = (i * self.batch) % self.traffic['pool_frames']
        sl = slice(start, start + self.batch)
        u = self.draw()
        ts = time.perf_counter()
        out = self.serve(to_device(self.host[0][sl], self.dev),
                         to_device(self.host[1][sl], self.dev),
                         ransac_uniforms=u)
        self.host_s = time.perf_counter() - ts
        return start, u, out

    def numbers(self, control: bool = False, detail: bool = False) -> dict:
        out, u, idx = self.sample()
        rows = idx.cpu().numpy()
        frames = torch.from_numpy(self.host[0][rows]).to(self.dev)
        boxes = torch.from_numpy(self.host[1][rows]).to(self.dev)
        ref = ref_serve.load(self.ctx.weights_path(), self.cfg,
                             self.dev).eval()
        if control:
            out = check.control_outputs(ref, frames, boxes, u, self.pts,
                                        self.cfg)
        return check.serve_numbers(ref, frames, boxes, u, out, self.pts,
                                   self.cfg, detail=detail)


def run(ctx) -> dict:
    return _closed_loop.run(ctx, ServeHost)


def readings(args, wl):
    """The readings the cell's limits are set from (``readings.py``)."""
    return _closed_loop.readings(args, ServeHost)
