"""Closed-loop serving of HRFormer through ``pipeline.make_jitted_pipeline``:
``serve_closed``'s traffic loop (its calls sent ahead, its pool, its kept
rows; run by ``_closed_loop``), with the program's model made from the
seed in set-up and ``serve_vit``'s judge, which knows the heatmaps'
stride.

The model is the port's ``models/hrformer.HRFormer`` in the
configuration's ``compute_dtype`` (bf16; its convs stored in it, as the
HRNet serving form stores them), loaded with ``strict=True`` from the
reference's seeded state dict (``reference/hrformer.seeded_state_dict``,
drawn on the card from the seed), so the program and the reference hold
the same f32 draws.

The judge is ``serve_vit.vit_numbers`` on the reference's crop, f32
HRFormer, decode and solve (see its module's docstring for each number).
It reads the stride from ViTPose's geometry keys (a patch grid and its
deconvs); :func:`judge_config` gives HRFormer's stride of 4 in those keys:
a grid of 4-pixel cells and no deconvolution, which is what the stem's two
stride-2 convs and the 1x1 head amount to.  The control is
``serve_vit.control_outputs`` with the HRFormer reference in fp8
(``reference/hrformer.fp8``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from h100_bench import traffic
from h100_bench.drivers import _closed_loop, serve_closed, serve_vit
from h100_bench.reference import hrformer as ref_hrf


def seeded_weights(cfg: dict, seed: int, device) -> dict:
    return ref_hrf.seeded_state_dict(
        cfg, traffic.generator(device, seed, 'weights'))


def port_config(cfg: dict):
    """The port's ``HRFormerConfig`` of configuration ``cfg``."""
    from esa_pose_estimation_tpu_torch.utils.config import (
        HRFormerConfig,
        HRFormerStageConfig,
        StageConfig,
    )
    ch, heads = tuple(cfg['channels']), tuple(cfg['heads'])
    stages = [HRFormerStageConfig(m, n, (cfg['blocks_per_branch'],) * n,
                                  ch[:n], num_heads=heads[:n],
                                  window_size=cfg['window'],
                                  mlp_ratio=cfg['mlp_ratio'])
              for n, m in zip((2, 3, 4), cfg['modules'])]
    return HRFormerConfig(
        num_keypoints=cfg['num_keypoints'], img_size=cfg['crop_size'],
        stem_channels=cfg['stem_channels'],
        stage1=StageConfig(1, 1, (cfg['stage1_blocks'],),
                           (cfg['stage1_planes'],), 'BOTTLENECK'),
        stage2=stages[0], stage3=stages[1], stage4=stages[2])


def program_model(cfg: dict, seed: int, device):
    """The port's HRFormer in the configuration's ``compute_dtype`` on
    ``device``, eval mode, with the seed's weights, its convs stored in
    that dtype."""
    from esa_pose_estimation_tpu_torch.models.hrformer import HRFormer
    from esa_pose_estimation_tpu_torch.models.layers import (
        store_in_compute_dtype,
    )
    with torch.device('meta'):
        model = HRFormer(port_config(cfg),
                         dtype=getattr(torch, cfg['compute_dtype']))
    model = model.to_empty(device=device)
    model.load_state_dict(seeded_weights(cfg, seed, device), strict=True)
    return store_in_compute_dtype(model.to(
        memory_format=torch.channels_last)).eval()


def reference_model(cfg: dict, seed: int, device) -> ref_hrf.HRFormer:
    with torch.device('meta'):
        model = ref_hrf.HRFormer(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(seeded_weights(cfg, seed, device), strict=True)
    return model.eval()


def judge_config(cfg: dict) -> dict:
    """``cfg`` with the keys ``serve_vit``'s judge reads the stride from:
    a grid of ``stride``-pixel cells and no deconvolution."""
    s = ref_hrf.stride(cfg)
    return {**cfg, 'patch_size': s, 'patch_padding': 0, 'head_channels': []}


class ServeHRFormer(serve_closed.Serve):
    """``serve_closed.Serve`` with the seed's HRFormer as the program and
    ``serve_vit.vit_numbers`` as the judge."""

    def __init__(self, ctx):
        cfg, seed, dev = ctx.config, ctx.seed, ctx.device
        super().__init__(SimpleNamespace(**{
            **vars(ctx),
            'program_model': lambda train=False: program_model(cfg, seed,
                                                               dev)}))

    def numbers(self, control: bool = False, detail: bool = False) -> dict:
        out, u, idx = self.sample()
        frames = self.pool.frames.index_select(0, idx)
        boxes = self.pool.boxes.index_select(0, idx)
        ref = reference_model(self.cfg, self.ctx.seed, self.dev)
        cfg = judge_config(self.cfg)
        if control:
            with ref_hrf.fp8(True):
                out = serve_vit.control_outputs(ref, frames, boxes, u,
                                                self.pts, cfg)
        return serve_vit.vit_numbers(ref, frames, boxes, u, out, self.pts,
                                     cfg, detail=detail)


def run(ctx) -> dict:
    return _closed_loop.run(ctx, ServeHRFormer)


def readings(args, wl):
    """The readings the cell's limits are set from (``readings.py``)."""
    return _closed_loop.readings(args, ServeHRFormer)
