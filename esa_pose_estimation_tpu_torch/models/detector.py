"""Single-class spacecraft detector (anchor-free, center-heatmap style).

Torch port of the JAX package's ``models/detector.py``: a strided conv
backbone to stride 8, 16 or 32, an objectness heatmap head and a box head
(center offset + log size), decoded CenterNet-style with a 3x3 max-pool
peak NMS and the batched box NMS of ``ops/nms.py``; trained with
:func:`detection_loss` on :func:`detection_targets`
(``cli/train_detector.py``).  It fills the role of the reference's offline
YOLOv5s stage (simple_detect.py:5-19), in the serving graph: detect ->
crop -> keypoint (``pipeline.detect_and_infer``).

Submodule names follow the Flax auto-numbering of the JAX model
(``ConvBN_0`` ... ``ConvBN_{2n}``, ``heatmap_head``, ``offset_head``,
``size_head``), so ``utils/artifact.from_jax_variables`` maps a JAX
variable tree onto it leaf by leaf.  It runs in float32 for training and
serving alike, as the JAX package builds it; its BatchNorms follow Flax's
train-mode rule (``models/layers.BatchNorm``) at momentum 0.9, faster than
the keypoint nets' 0.99, since the detector trains briefly and must
evaluate with converged running statistics.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.models.layers import ConvBN, lecun_normal_
from esa_pose_estimation_tpu_torch.ops.nms import batched_nms

_N_DOWN = {8: 3, 16: 4, 32: 5}


class TinyDetector(nn.Module):
    """Input (B, H, W, 1) -> dict of f32 (B, H/s, W/s, .) maps at
    ``stride`` s (each stride-2 conv rounds up: 300x480 gives 19x30 at 16):

    * ``heatmap``: (..., 1) objectness logits;
    * ``offset``: (..., 2) sub-cell center offset in [0, 1];
    * ``size``: (..., 2) log box size in stride units.
    """

    def __init__(self, width: int = 32, stride: int = 16):
        super().__init__()
        self.width = width
        self.stride = stride
        cin, i = 1, 0
        for d in range(_N_DOWN[stride]):
            ch = min(width * 2 ** d, 256)
            for s in (2, 1):
                self.add_module(f'ConvBN_{i}',
                                ConvBN(cin, ch, 3, s, bn_momentum=0.9))
                cin, i = ch, i + 1
        self.add_module(f'ConvBN_{i}', ConvBN(cin, 256, 3, 1,
                                              bn_momentum=0.9))
        self.n_convbn = i + 1
        for name, cout in (('heatmap_head', 1), ('offset_head', 2),
                           ('size_head', 2)):
            self.add_module(name, nn.Conv2d(256, cout, 3, padding=1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> TinyDetector:
        """Draw the weights as the JAX model initialises them: conv kernels
        LeCun normal (truncated at 2 std), BatchNorm identity, head biases
        0 and the heatmap bias -4.  Draws on the generator's device."""
        for name, p in self.named_parameters():
            if name.endswith('weight') and p.dim() == 4:
                lecun_normal_(p, generator)
            elif 'BatchNorm' in name:
                p.fill_(1.0 if name.endswith('weight') else 0.0)
            else:
                p.fill_(-4.0 if name == 'heatmap_head.bias' else 0.0)
        for name, buf in self.named_buffers():
            buf.fill_(1.0 if name.endswith('running_var') else 0.0)
        return self

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(torch.float32).contiguous(
            memory_format=torch.channels_last)
        for i in range(self.n_convbn):
            x = getattr(self, f'ConvBN_{i}')(x)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)
        return {'heatmap': nhwc(self.heatmap_head(x)),
                'offset': nhwc(torch.sigmoid(self.offset_head(x))),
                'size': nhwc(self.size_head(x))}


def decode_detections(outputs: dict[str, torch.Tensor], stride: int,
                      top_k: int = 32, iou_threshold: float = 0.45,
                      score_threshold: float = 0.25, max_outputs: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Heatmap peaks -> boxes -> NMS, batched.

    Returns (boxes (B, max_outputs, 4) [x1, y1, x2, y2] in input pixels,
    scores, valid mask).  Peaks are the cells that equal their 3x3
    neighbourhood's maximum (``-inf`` padding, plateaus kept); the
    ``top_k`` are taken by a stable sort, so ties go in index order as in
    JAX's ``lax.top_k``.
    """
    logits = outputs['heatmap'][..., 0]                     # (B, Hs, Ws)
    b, hs, ws = logits.shape
    prob = torch.sigmoid(logits)
    pooled = F.max_pool2d(prob[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(prob >= pooled, prob, 0.0).reshape(b, hs * ws)

    top_k = min(top_k, hs * ws)
    scores, idx = torch.sort(peaks, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    cy = torch.div(idx, ws, rounding_mode='floor').to(torch.float32)
    cx = (idx % ws).to(torch.float32)

    def take(a):
        flat = a.reshape(b, hs * ws, a.shape[-1])
        return torch.gather(flat, 1, idx[..., None].expand(b, top_k,
                                                           a.shape[-1]))
    off = take(outputs['offset'])
    size = take(outputs['size'])
    cxf = (cx + off[..., 0]) * stride
    cyf = (cy + off[..., 1]) * stride
    bw = torch.exp(torch.clamp(size[..., 0], -8.0, 8.0)) * stride
    bh = torch.exp(torch.clamp(size[..., 1], -8.0, 8.0)) * stride
    boxes = torch.stack([cxf - bw / 2, cyf - bh / 2,
                         cxf + bw / 2, cyf + bh / 2], dim=-1)
    return batched_nms(boxes, scores, iou_threshold, score_threshold,
                       max_outputs)


def detection_targets(bboxes: torch.Tensor, grid_hw: tuple[int, int],
                      stride: int, sigma_scale: float = 12.0
                      ) -> dict[str, torch.Tensor]:
    """Training targets for one box per image (SPEED has a single object).
    bboxes: (B, 4) [x1, y1, x2, y2] pixels -> (B, Hs, Ws, .) maps."""
    hs, ws = grid_hw
    dev = bboxes.device
    cx = (bboxes[:, 0] + bboxes[:, 2]) / 2 / stride
    cy = (bboxes[:, 1] + bboxes[:, 3]) / 2 / stride
    bw = (bboxes[:, 2] - bboxes[:, 0]) / stride
    bh = (bboxes[:, 3] - bboxes[:, 1]) / stride
    xs = torch.arange(ws, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(hs, dtype=torch.float32, device=dev)[None, :, None]
    sigma2 = torch.clamp(bw * bh, min=1.0)[:, None, None] / sigma_scale
    heat = torch.exp(-((xs - cx[:, None, None]) ** 2
                       + (ys - cy[:, None, None]) ** 2) / (2 * sigma2))
    cell_x = torch.floor(cx)
    cell_y = torch.floor(cy)
    is_center = ((xs == cell_x[:, None, None])
                 & (ys == cell_y[:, None, None]))
    # the center cell is an exact positive (CenterNet convention)
    heat = torch.maximum(heat, is_center.to(heat.dtype))

    def plane(v):
        return v[:, None, None].expand(heat.shape)
    offset = torch.stack([plane(cx - cell_x), plane(cy - cell_y)], dim=-1)
    size = torch.stack([plane(torch.log(torch.clamp(bw, min=1e-3))),
                        plane(torch.log(torch.clamp(bh, min=1e-3)))], dim=-1)
    return {'heatmap': heat[..., None], 'offset': offset, 'size': size,
            'center_mask': is_center[..., None].to(torch.float32)}


def detection_loss(outputs: dict[str, torch.Tensor],
                   targets: dict[str, torch.Tensor]) -> torch.Tensor:
    """Penalty-reduced focal loss on the heatmap + L1 on the offset and the
    size at the center cell (CenterNet-style), a scalar: the JAX package's
    ``detection_loss``."""
    prob = torch.sigmoid(outputs['heatmap'])
    gt = targets['heatmap']
    pos = (gt >= 0.999).to(torch.float32)
    neg_w = (1.0 - gt) ** 4
    eps = 1e-6
    pos_loss = -torch.log(prob + eps) * (1 - prob) ** 2 * pos
    neg_loss = -torch.log(1 - prob + eps) * prob ** 2 * neg_w * (1 - pos)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    heat_loss = (pos_loss.sum() + neg_loss.sum()) / n_pos

    cm = targets['center_mask']
    n_center = torch.clamp(cm.sum(), min=1.0)
    reg_loss = ((outputs['offset'] - targets['offset']).abs() * cm).sum() \
        / n_center
    size_loss = ((outputs['size'] - targets['size']).abs() * cm).sum() \
        / n_center
    return heat_loss + reg_loss + 0.1 * size_loss


def save_detector_config(workdir: str, **cfg) -> None:
    """Write ``detector.json`` into a detector workdir.

    The detector's downscale, stride and width are baked into its weights
    (a downscale-8 detector decodes garbage on downscale-4 inputs), so the
    training command records them and the consumers read them back instead
    of trusting a flag to match.
    """
    with open(os.path.join(workdir, 'detector.json'), 'w') as f:
        json.dump(cfg, f, indent=1)


def load_detector_config(workdir: str) -> dict | None:
    """Read ``detector.json`` from a detector workdir; None if absent
    (older workdirs fall back to the caller's defaults)."""
    path = os.path.join(workdir, 'detector.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
