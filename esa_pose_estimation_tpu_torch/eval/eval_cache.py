"""Crop-once held-out evaluation (torch port of the JAX package's
``eval/eval_cache.py``).

For a FIXED evaluation split the crop stage does not change between
evaluations, only the weights do.  :class:`EvalCache` iterates the
frame-carrying batches once, runs the box rule and the bilinear resample on
the device, and keeps the 128x128 crops (65 KB a frame, against 2.3 MB for
the frame) resident with their uncrop transform; the labels stay on the
host.  Each evaluation then runs only ``pipeline.infer_poses_from_crops``
per batch, with whatever model it is given: on the card one CUDA graph
per batch shape (``utils/graphs.Graphed``), replayed with the crops and
the RANSAC uniforms copied in, as the JAX package jits the same tail.

Batches may hold host arrays (a loader's) or tensors (``data.synthetic.
make_batch(..., with_frames=True)`` on the card).  The first batch keeps
its first ``n_panels`` frames and boxes on the host, for eval image
panels.  ``timing`` splits the build into host decode
(``decode_s``: the loader's iteration) and device crop (``crop_stage_s``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from esa_pose_estimation_tpu_torch import pipeline as pipeline_mod
from esa_pose_estimation_tpu_torch.data.speed import to_device
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import pnp as pnp_mod
from esa_pose_estimation_tpu_torch.utils import graphs


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class EvalCache:
    """``model`` gives the device the crops live on (its parameters')."""

    def __init__(self, model, eval_batches, points_3d, crop_size: int = 128,
                 norm_mean: float = 0.449, norm_std: float = 0.229,
                 n_panels: int = 4, conf_threshold: float = 0.6,
                 min_keypoints: int = 0, n_hypotheses: int = 32,
                 frame_hw: tuple[int, int] = (1200, 1920)):
        dev = next(model.parameters()).device
        self.points_3d = torch.as_tensor(points_3d, dtype=torch.float32,
                                         device=dev)
        self.infer_kw = dict(conf_threshold=conf_threshold,
                             min_keypoints=min_keypoints,
                             n_hypotheses=n_hypotheses, norm_mean=norm_mean,
                             norm_std=norm_std)
        t0 = time.perf_counter()
        self.batches: list[dict] = []
        decode_s = 0.0
        td = time.perf_counter()
        for i, b in enumerate(eval_batches):
            decode_s += time.perf_counter() - td   # host decode + assemble
            crops, rates, origins = crop_ops.crop_resize(
                to_device(b['frame'], dev), to_device(b['bbox'], dev),
                crop_size, img_w=frame_hw[1], img_h=frame_hw[0])
            entry = {
                'crop': crops, 'rate': rates, 'origin': origins,
                'quat': _host(b['quat']),
                'trans': _host(b['trans']),
            }
            if 'keypoints_2d' in b:
                entry['keypoints_2d'] = _host(b['keypoints_2d'])
            if i == 0:
                # panels only read the first n_panels frames of batch 0
                entry['frame'] = _host(b['frame'][:n_panels])
                entry['bbox'] = _host(b['bbox'][:n_panels])
            self.batches.append(entry)
            td = time.perf_counter()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        self.timing = {
            'decode_s': round(decode_s, 2),
            'crop_stage_s': round(time.perf_counter() - t0 - decode_s, 2),
        }
        self.graphs = graphs.Graphed(pipeline_mod.infer_poses_from_crops)

    @property
    def n_frames(self) -> int:
        return sum(e['crop'].shape[0] for e in self.batches)

    def infer(self, model, batch: dict,
              generator: torch.Generator | None = None
              ) -> pipeline_mod.PoseOutput:
        """The crops of one cached batch (already on the device) -> poses
        under ``model``, the RANSAC uniforms drawn from ``generator``."""
        crops = batch['crop']
        uniforms = pnp_mod.draw_ransac_uniforms(
            generator, crops.shape[:1], self.points_3d.shape[-2],
            self.infer_kw['n_hypotheses'], crops.device)
        return self.graphs(model, crops, batch['rate'], batch['origin'],
                           self.points_3d, ransac_uniforms=uniforms,
                           **self.infer_kw)
