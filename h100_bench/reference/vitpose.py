"""The plain reference of ViTPose-H (Xu, Zhang, Zhang and Tao, "ViTPose:
Simple Vision Transformer Baselines for Human Pose Estimation", NeurIPS
2022, arXiv:2204.12484; github.com/ViTAE-Transformer/ViTPose,
``configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/coco/
ViTPose_huge_coco_256x192.py``), in plain PyTorch and float32 (TF32 off),
written from the published equations.  It imports nothing of the port.

* patch embedding: a 16x16 conv of stride 16 and padding 2 over 3
  channels; then ``x + pos_embed[:, 1:] + pos_embed[:, :1]``;
* 32 pre-norm blocks: ``x += proj(attn(LN1(x)))``, then
  ``x += fc2(GELU(fc1(LN2(x))))``; LayerNorm eps 1e-6; one ``qkv`` linear
  with bias; 16 heads of 80, ``softmax(q k^T * 80 ** -0.5) v`` written
  out over all tokens; exact-erf GELU; drop-path the identity;
* ``last_norm``; the tokens as a (B, 1280, 32, 32) map;
* ``TopdownHeatmapSimpleHead``: two deconvs (kernel 4, stride 2, padding
  1, 256 channels, no bias), each with BatchNorm (eval) and ReLU, and a
  1x1 conv with bias to the heatmaps, at a quarter of the input.

Departures from the published model, all of the configuration
(``configs/vitpose_h_serve.json``'s ``assumed``): the 3 input channels are
fed one grey crop, repeated; 30 heatmaps, not COCO's 17; a 512x512 input,
not 256x192, so ``pos_embed`` covers 32x32 patches (and the class token's
row); seeded weights (:func:`seeded_state_dict`), not trained ones.

Module names follow the published checkpoint's ``state_dict`` keys, so one
state dict loads into the port and into this with ``strict=True``.

``FP8`` (:func:`fp8`) is the control of the correctness check, one
precision below the configuration's bf16: every linear, conv and
deconv, and both attention products, on e4m3 operands (each scaled by its
largest magnitude onto e4m3's range and rounded, as ``net.FP8`` does for
the HRNet's convs), multiplied in f32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.net import fp8_round

FP8 = False
FRAMES_PER_BLOCK = 8     # frames a forward computes at once


@contextlib.contextmanager
def fp8(on: bool):
    global FP8
    prev, FP8 = FP8, on
    try:
        yield
    finally:
        FP8 = prev


def _q(x: torch.Tensor) -> torch.Tensor:
    return fp8_round(x) if FP8 else x


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_q(x), _q(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(_q(x), _q(self.weight), self.bias, self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(_q(x), _q(self.weight), self.bias,
                                  self.stride, self.padding)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, padding: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch, padding=padding)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)      # (B, N, D)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)              # (B, H, N, hd)
        a = torch.softmax((_q(q) @ _q(k).transpose(-2, -1)) * self.scale,
                          dim=-1)
        o = _q(a) @ _q(v)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Backbone(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg['embed_dim']
        self.grid = grid(cfg)
        self.patch_embed = PatchEmbed(d, cfg['patch_size'],
                                      cfg['patch_padding'])
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg['num_heads'], cfg['mlp_ratio'], cfg['ln_eps'])
            for _ in range(cfg['depth']))
        self.last_norm = nn.LayerNorm(d, eps=cfg['ln_eps'])

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        return x.transpose(1, 2).reshape(x.shape[0], -1, self.grid,
                                         self.grid)


class Head(nn.Module):
    def __init__(self, cin: int, channels: list, keypoints: int):
        super().__init__()
        layers = []
        for c in channels:
            layers += [ConvTranspose2d(cin, c, 4, stride=2, padding=1,
                                       bias=False),
                       nn.BatchNorm2d(c), nn.ReLU()]
            cin = c
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv2d(cin, keypoints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """(B, S, S, 1) normalised grey crops -> (B, S/4, S/4, K) f32
    heatmaps, :data:`FRAMES_PER_BLOCK` frames at a time.  Use in eval
    mode (BatchNorm's running statistics)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = Backbone(cfg)
        self.keypoint_head = Head(cfg['embed_dim'], cfg['head_channels'],
                                  cfg['num_keypoints'])

    def forward(self, x):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = [self._forward(x[s:s + FRAMES_PER_BLOCK])
                   for s in range(0, x.shape[0], FRAMES_PER_BLOCK)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return torch.cat(out)

    def _forward(self, x):
        x = x.to(torch.float32).permute(0, 3, 1, 2).expand(-1, 3, -1, -1)
        hm = self.keypoint_head(self.backbone(x))
        return hm.permute(0, 2, 3, 1)


def grid(cfg: dict) -> int:
    """Patches along a side."""
    return ((cfg['crop_size'] + 2 * cfg['patch_padding']
             - cfg['patch_size']) // cfg['patch_size'] + 1)


def stride(cfg: dict) -> int:
    """Crop pixels per heatmap pixel."""
    return cfg['crop_size'] // (grid(cfg) * 2 ** len(cfg['head_channels']))


@torch.no_grad()
def seeded_state_dict(cfg: dict, generator: torch.Generator
                      ) -> dict[str, torch.Tensor]:
    """The published initialisation, drawn on ``generator``'s device in
    f32: linears and ``pos_embed`` truncated normal of std 0.02 (within
    +-2, timm's ``trunc_normal_``), their biases 0; LayerNorm 1 and 0; the
    patch conv as PyTorch's default (uniform within 1/sqrt(fan in), bias
    too); the deconvs normal of std 0.001, BatchNorm 1 and 0 with running
    mean 0 and variance 1; the final layer normal of std
    ``cfg['head_final_std']`` (the published 0.001, or the scale the
    configuration assumes), its bias 0."""
    dev = generator.device
    with torch.device('meta'):
        shapes = {k: (v.shape, v.dtype)
                  for k, v in ViTPose(cfg).state_dict().items()}
    out = {}
    for name, (shape, dtype) in shapes.items():
        t = torch.empty(shape, dtype=dtype, device=dev)
        leaf = name.rsplit('.', 1)[-1]
        if name == 'backbone.pos_embed' or (
                '.blocks.' in name and t.dim() == 2):
            nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                  generator=generator)
        elif name.startswith('backbone.patch_embed.proj.'):
            fan_in = math.prod(shapes['backbone.patch_embed.proj.weight'][0]
                               [1:])
            bound = 1.0 / math.sqrt(fan_in)
            t.uniform_(-bound, bound, generator=generator)
        elif name.startswith('keypoint_head.final_layer.'):
            if leaf == 'weight':
                t.normal_(0.0, cfg['head_final_std'], generator=generator)
            else:
                t.zero_()
        elif name.startswith('keypoint_head.deconv_layers.') and t.dim() == 4:
            t.normal_(0.0, 0.001, generator=generator)
        elif leaf in ('weight', 'running_var'):     # LayerNorm, BatchNorm
            t.fill_(1.0)
        else:           # biases, running means, num_batches_tracked
            t.zero_()
        out[name] = t
    return out
