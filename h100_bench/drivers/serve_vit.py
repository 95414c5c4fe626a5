"""Closed-loop serving of ViTPose through ``pipeline.make_jitted_pipeline``:
``serve_closed``'s traffic loop (its calls sent ahead, its pool, its kept
rows), with the program's model made from the seed in set-up and a judge
that knows the heatmaps' stride.

The model is the port's ``models/vitpose.ViTPose`` in the configuration's
``compute_dtype`` (bf16), loaded with
``strict=True`` from the reference's seeded state dict
(``reference/vitpose.seeded_state_dict``, drawn on the card from the
seed), so the program and the reference hold the same f32 draws.

The judge (:func:`vit_numbers`) compares, in blocks of frames, the served
outputs with the plain reference (crop, f32 ViTPose, decode and solve)
on the same frames, boxes and RANSAC uniforms, the stride (crop size over
heatmap size) folded into the rates the decode and the solve are given:

* ``heatmap_gap``: per frame the widest gap between the served heatmaps
  and the reference's, over the reference's largest magnitude in that
  frame (the seeded head's scale does not set the limit); the widest
  frame;
* ``keypoint_gap_px``: the widest gap between the served keypoints and
  the reference's decode of the served heatmaps;
* ``confidence_gap``: the widest gap between the served confidences and
  the reference's own (its heatmaps' maxima);
* ``solve_rotation_gap_median_rad``, ``solve_translation_gap_median``:
  the median over the frames of the served pose's gap to the reference's
  selection, RANSAC-EPnP and dual LM on the served keypoints, confidences
  and heatmaps (the translation relative): the bulk's precision;
* ``solve_far_share``: the share of the frames whose served pose lies
  further than ``FAR_RAD`` or ``FAR_REL`` from that solve's, so that every
  frame counts: a solve left out, or a pose from another frame, in a
  quarter of the batch reads 0.25 and more.

With seeded weights the heatmaps' peaks lie where noise puts them, and the
keypoints pose a weakly conditioned PnP: an order of summation alone moves
the chosen hypothesis, the LM's end or the mirror's pick, in a few percent
of a seed's frames and by up to 3 rad (the reference against itself, on
the card and on the CPU).  So the frames are not held one by one to the
reference's pose.  Reported and not compared: the 99th percentile of the
solve's gaps (``solve_rotation_gap_p99_rad``,
``solve_translation_gap_p99``), and the reference's own end-to-end pose
(``rotation_gap_p99_rad``, ``translation_gap_p99``), since a rounding that
moves one argmax of the near-flat seeded maps moves it.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from h100_bench import check, harness, traffic
from h100_bench.drivers import serve_closed
from h100_bench.reference import crop
from h100_bench.reference import serve as ref_serve
from h100_bench.reference import vitpose as ref_vit

FIELDS = serve_closed.FIELDS
# A served pose further than these from the reference's solve is another
# solution (rounding alone moves the LM's end by ~1e-3 rad at most on the
# frames that agree).
FAR_RAD = 1e-2
FAR_REL = 1e-2


def seeded_weights(cfg: dict, seed: int, device) -> dict:
    return ref_vit.seeded_state_dict(
        cfg, traffic.generator(device, seed, 'weights'))


def port_config(cfg: dict):
    """The port's ``ViTPoseConfig`` of configuration ``cfg``."""
    from esa_pose_estimation_tpu_torch.utils.config import ViTPoseConfig
    return ViTPoseConfig(
        num_keypoints=cfg['num_keypoints'], img_size=cfg['crop_size'],
        patch_size=cfg['patch_size'], patch_padding=cfg['patch_padding'],
        embed_dim=cfg['embed_dim'], depth=cfg['depth'],
        num_heads=cfg['num_heads'], mlp_ratio=cfg['mlp_ratio'],
        ln_eps=cfg['ln_eps'], head_channels=tuple(cfg['head_channels']))


def program_model(cfg: dict, seed: int, device):
    """The port's ViTPose in the configuration's ``compute_dtype`` on
    ``device``, eval mode, with the seed's weights."""
    from esa_pose_estimation_tpu_torch.models.vitpose import ViTPose
    with torch.device('meta'):
        model = ViTPose(port_config(cfg),
                        dtype=getattr(torch, cfg['compute_dtype']))
    model = model.to_empty(device=device)
    model.load_state_dict(seeded_weights(cfg, seed, device), strict=True)
    return model.eval()


def reference_model(cfg: dict, seed: int, device) -> ref_vit.ViTPose:
    with torch.device('meta'):
        model = ref_vit.ViTPose(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(seeded_weights(cfg, seed, device), strict=True)
    return model.eval()


@torch.no_grad()
def heatmaps(model, frames: torch.Tensor, boxes: torch.Tensor,
             crop_size: int, low: bool = False):
    """The reference's crop and network (``reference/serve.heatmaps`` with
    ViTPose; ``low``: its input in bf16 and the network in fp8)."""
    crops, rates, origins = crop.crop_resize(
        frames, boxes, crop_size, img_w=frames.shape[2],
        img_h=frames.shape[1], force_square=True)
    if low:
        crops = crops.to(torch.bfloat16).to(torch.float32)
    with ref_vit.fp8(low):
        hm = model(crop.normalize(crops)[..., None])
    return hm, rates, origins


def vit_numbers(ref_model, frames: torch.Tensor, boxes: torch.Tensor,
                uniforms: torch.Tensor, out: dict, pts: torch.Tensor,
                cfg: dict, block: int = 64,
                detail: bool = False) -> dict[str, float]:
    """The served outputs ``out`` judged against the reference (see the
    module's docstring), in blocks of ``block`` frames.  ``detail`` adds
    readings that are not compared (widest gaps, medians)."""
    serving, stride = cfg['serving'], ref_vit.stride(cfg)
    rows: dict[str, list] = {}

    def add(key, value):
        rows.setdefault(key, []).append(value.reshape(value.shape[0], -1)
                                        .amax(-1).cpu())

    for s in range(0, frames.shape[0], block):
        sl = slice(s, s + block)
        hm = out['heatmaps'][sl].to(torch.float32)
        hm_ref, rates, origins = heatmaps(ref_model, frames[sl], boxes[sl],
                                          cfg['crop_size'])
        gap = check._gap(hm, hm_ref).flatten(1).amax(1)
        add('heatmap_gap', gap / hm_ref.abs().flatten(1).amax(1).double())
        add('heatmap_gap_abs', gap)
        rates = rates / stride
        kp_ref, _ = ref_serve.decode(hm, rates, origins)
        add('keypoint_gap_px', check._gap(out['keypoints_2d'][sl], kp_ref))
        kp_own, conf_own = ref_serve.decode(hm_ref, rates, origins)
        add('confidence_gap', check._gap(out['confidences'][sl], conf_own))
        R_tf, t_tf = ref_serve.solve(
            pts, out['keypoints_2d'][sl], out['confidences'][sl], hm, rates,
            origins, uniforms[sl], serving)
        rot = check._angle(out['R'][sl], R_tf)
        trans = check._rel(out['trans'][sl], t_tf)
        add('solve_rotation_gap_rad', rot)
        add('solve_translation_gap', trans)
        add('solve_far', ((rot > FAR_RAD) | (trans > FAR_REL)).double())
        R_own, t_own = ref_serve.solve(pts, kp_own, conf_own, hm_ref, rates,
                                       origins, uniforms[sl], serving)
        add('rotation_gap_rad', check._angle(out['R'][sl], R_own))
        add('translation_gap', check._rel(out['trans'][sl], t_own))
    rows = {k: torch.cat(v).double() for k, v in rows.items()}
    res = {'heatmap_gap': float(rows['heatmap_gap'].max()),
           'keypoint_gap_px': float(rows['keypoint_gap_px'].max()),
           'confidence_gap': float(rows['confidence_gap'].max()),
           'solve_rotation_gap_median_rad': float(
               rows['solve_rotation_gap_rad'].median()),
           'solve_translation_gap_median': float(
               rows['solve_translation_gap'].median()),
           'solve_far_share': float(rows['solve_far'].mean()),
           'solve_rotation_gap_p99_rad': check._p99(
               rows['solve_rotation_gap_rad']),
           'solve_translation_gap_p99': check._p99(
               rows['solve_translation_gap']),
           'rotation_gap_p99_rad': check._p99(rows['rotation_gap_rad']),
           'translation_gap_p99': check._p99(rows['translation_gap'])}
    if detail:
        for k, v in rows.items():
            res[k + '.max'] = float(v.max())
            res[k + '.p99'] = check._p99(v)
            res[k + '.p90'] = float(torch.quantile(v, 0.9))
            res[k + '.median'] = float(v.median())
    return res


def control_outputs(ref_model, frames: torch.Tensor, boxes: torch.Tensor,
                    uniforms: torch.Tensor, pts: torch.Tensor, cfg: dict,
                    block: int = 64) -> dict[str, torch.Tensor]:
    """The reference in the program's place, one precision below the
    configuration's (fp8 network, bf16 decode, TF32 solver), at the
    stride."""
    stride = ref_vit.stride(cfg)
    parts: dict[str, list] = {k: [] for k in FIELDS}
    for s in range(0, frames.shape[0], block):
        sl = slice(s, s + block)
        hm, rates, origins = heatmaps(ref_model, frames[sl], boxes[sl],
                                      cfg['crop_size'], low=True)
        rates = rates / stride
        kp, conf = ref_serve.decode(hm, rates, origins, low=True)
        R, t = ref_serve.solve(pts, kp, conf, hm, rates, origins,
                               uniforms[sl], cfg['serving'], low=True)
        for k, v in zip(FIELDS, (hm, kp, conf, R, t)):
            parts[k].append(v)
    return {k: torch.cat(v) for k, v in parts.items()}


class ServeViT(serve_closed.Serve):
    """``serve_closed.Serve`` with the seed's ViTPose as the program and
    :func:`vit_numbers` as the judge."""

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
        if control:
            out = control_outputs(ref, frames, boxes, u, self.pts, self.cfg)
        return vit_numbers(ref, frames, boxes, u, out, self.pts, self.cfg,
                           detail=detail)


def run(ctx) -> dict:
    s = ServeViT(ctx)
    s.setup()
    setup_s = time.time() - ctx.t0
    gpu = harness.gpu_state()
    win = harness.Window(ctx.seconds)
    if s.ahead:
        win.run_ahead(s.send, s.wait, s.ahead)
    else:
        win.run(s.call)
    gpu = f'before the window: {gpu}; after: {harness.gpu_state()}'
    attempted, failed = s.attempted, s.failed
    peak = ctx.memory_peak()
    metrics = {'setup_s': setup_s,
               'serve_images_per_s': harness.rate(attempted, win.elapsed),
               'serve_p95_ms': harness.p95(win.latencies()) * 1e3}
    layer, breakdown, busy = None, None, None
    if ctx.trace:
        layer, breakdown, busy = serve_closed.traced(
            ctx, s, win.calls, metrics['serve_images_per_s'])
    s.free_program()
    numbers = s.numbers()
    return {'metrics': metrics, 'layer': layer, 'breakdown': breakdown,
            'busy': busy, 'attempted': attempted, 'failed': failed,
            'numbers': numbers, 'peak': peak, 'call_s': win.latencies(),
            'gpu': gpu}


def readings(args, wl):
    """The readings the cell's limits are set from (``readings.py``), as
    ``serve_closed.readings`` takes them."""
    from h100_bench import run as run_mod
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        s = ServeViT(run_mod.make_context(args.workload, seed, args.seconds,
                                          False, 'cuda'))
        s.setup()
        harness.Window(args.seconds).run(s.call)
        s.free_program()
        if seed in args.seeds:
            yield seed, 'program', s.numbers(detail=True)
        if seed in args.control_seeds:
            yield seed, 'control', s.numbers(control=True, detail=True)
