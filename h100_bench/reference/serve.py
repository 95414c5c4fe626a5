"""The plain reference of one serving call, in the three stages the check
compares: crop and network, decode, and the pose solve.

Each stage reads only the harness's inputs (frames, boxes, RANSAC
uniforms, the r5 weights it loaded itself) or the served outputs it judges
(``check.serve_numbers`` hands the program's heatmaps to :func:`decode`
and its keypoints, confidences and heatmaps to :func:`solve`).

``low=True`` computes a stage one precision below the configuration's, the
control of the check: the network in fp8 (``net.FP8``), the decode's f32
in bf16, and the solver's f32 products in TF32.
"""

from __future__ import annotations

import contextlib

import torch

from h100_bench.reference import camera, crop, net, peak, pnp


@contextlib.contextmanager
def _fp8(on: bool):
    prev, net.FP8 = net.FP8, on
    try:
        yield
    finally:
        net.FP8 = prev


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def heatmaps(model: net.HRNet, frames: torch.Tensor, boxes: torch.Tensor,
             crop_size: int, low: bool = False):
    """frames (B, H, W) and boxes (B, 4) -> heatmaps (B, S, S, K) f32,
    rates (B,), origins (B, 2): the square crop x1.05, bilinear to
    ``crop_size``, normalised, through the network."""
    crops, rates, origins = crop.crop_resize(
        frames, boxes, crop_size, img_w=frames.shape[2],
        img_h=frames.shape[1], force_square=True)
    if low:
        crops = crops.to(torch.bfloat16).to(torch.float32)
    with _fp8(low):
        hm = model(crop.normalize(crops)[..., None])
    return hm, rates, origins


@torch.no_grad()
def decode(hm: torch.Tensor, rates: torch.Tensor, origins: torch.Tensor,
           low: bool = False):
    """Heatmaps (B, S, S, K) -> full-frame keypoints (B, K, 2) and their
    confidences (B, K)."""
    if low:
        hm = hm.to(torch.bfloat16)
    coords, maxvals = peak.decode_heatmaps(hm.permute(0, 3, 1, 2))
    dt = torch.bfloat16 if low else torch.float32
    kp = (coords.to(dt) / rates[:, None, None].to(dt)
          + origins[:, None, :].to(dt))
    return kp.to(torch.float32), maxvals.to(dt).to(torch.float32)


@torch.no_grad()
def solve(pts: torch.Tensor, kp: torch.Tensor, conf: torch.Tensor,
          hm: torch.Tensor, rates: torch.Tensor, origins: torch.Tensor,
          uniforms: torch.Tensor, serving: dict, low: bool = False):
    """Keypoints, confidences and heatmaps -> (R, t): the confident
    selection, RANSAC-EPnP on the given uniforms, and the dual LM over the
    inliers weighted by confidence, the mirror pose chosen by heatmap
    evidence (the port's ``infer_poses_from_crops`` tail)."""
    K = camera.speed_k(torch.float32, kp.device)
    sel = peak.select_confident(conf, serving['conf_threshold'],
                                min_count=serving['min_keypoints'])
    p3 = pts.expand((kp.shape[0],) + pts.shape)
    iters = serving['lm_iters']
    with _tf32(low):
        init = pnp.ransac_epnp(p3, kp, K, None, valid=sel,
                               n_hypotheses=serving['n_hypotheses'],
                               sample_size=serving['sample_size'],
                               lm_iters=iters, uniforms=uniforms)
        keep = init.inliers & sel
        keep = torch.where((keep.sum(-1) >= 4)[..., None], keep, sel)
        w = torch.where(keep, conf, 0.0)
        ev = pnp.heatmap_evidence(hm.to(torch.float32), p3, K, rates, origins,
                                  valid=sel)
        return pnp.lm_refine_dual(p3, kp, w, K, init.R, init.t, iters=iters,
                                  evidence_fn=ev)


def load(path: str, cfg: dict, device, dtype=torch.bfloat16) -> net.HRNet:
    """The reference network of configuration ``cfg`` with the weights of
    the artifact at ``path`` (f32 masters), channels-last on ``device``."""
    from h100_bench.reference import weights
    model = build(cfg, dtype)
    model.load_state_dict(weights.read_state_dict(path), strict=True)
    return model.to(device=device, memory_format=torch.channels_last)


def build(cfg: dict, dtype=torch.bfloat16) -> net.HRNet:
    return net.HRNet(in_channels=cfg['in_channels'],
                     num_keypoints=cfg['num_keypoints'],
                     stem_channels=cfg['stem_channels'],
                     widths=tuple(cfg['widths']),
                     blocks=tuple(cfg['blocks']),
                     with_cbam=cfg['with_cbam'], dtype=dtype)
