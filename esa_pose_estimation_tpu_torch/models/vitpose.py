"""ViTPose: a plain vision transformer backbone and the classic heatmap
head (Xu, Zhang, Zhang and Tao, "ViTPose: Simple Vision Transformer
Baselines for Human Pose Estimation", NeurIPS 2022, arXiv:2204.12484;
github.com/ViTAE-Transformer/ViTPose, ``configs/body/2d_kpt_sview_rgb_img/
topdown_heatmap/coco/ViTPose_huge_coco_256x192.py``).

* patch embedding: a ``patch_size`` conv of stride ``patch_size`` and
  padding ``patch_padding`` over 3 channels, then the learned positions,
  ``x + pos_embed[:, 1:] + pos_embed[:, :1]`` (the class token's row is
  added to every patch, as the published backbone does);
* ``depth`` pre-norm blocks, ``x += proj(attn(LN1(x)))`` then
  ``x += fc2(GELU(fc1(LN2(x))))``: LayerNorm eps ``ln_eps``, one ``qkv``
  linear with bias, full softmax attention over all tokens with scale
  ``head_dim ** -0.5``, exact-erf GELU; drop-path is the identity;
* ``last_norm``, then the tokens as a (B, D, grid, grid) map;
* the classic head (``TopdownHeatmapSimpleHead``): stride-2 deconvs
  (kernel 4, padding 1, no bias), each followed by BatchNorm and ReLU,
  then a 1x1 conv with bias to the K heatmaps.

:class:`ViTPose` takes ``(B, S, S, 1)`` normalised grey crops, as
``pipeline.infer_poses_from_crops`` hands them over, repeats the grey
channel into the published three, and returns f32 ``(B, S/4, S/4, K)``
channels-last heatmaps, the layout the peak decode reads.  Submodule names
follow the published checkpoint's ``state_dict`` keys
(``backbone.blocks.<i>.attn.qkv``, ``keypoint_head.deconv_layers.<j>``,
...), so a checkpoint loads by name with ``strict=True``.

Parameters and activations are in the model's ``dtype`` (bf16 on the
card); PyTorch's LayerNorm of bf16 keeps its statistics in f32, and flash
attention's softmax is f32.  Attention is
``F.scaled_dot_product_attention`` pinned to :data:`SDPA_BACKEND`.

Each forward runs inside the recorder's stages (``obs/profiling.stage``)
``vit_encoder`` (embedding, blocks, last norm), ``attention`` (each
block's attention product alone) and ``vit_head``; :func:`attention`
counts its calls (``launches``) and the query tokens it attended
(``tokens``), which follow the card in a CUDA graph
(``utils/graphs._counts``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from esa_pose_estimation_tpu_torch.obs.profiling import stage
from esa_pose_estimation_tpu_torch.utils.config import ViTPoseConfig

SDPA_BACKEND = SDPBackend.FLASH_ATTENTION
PATCH_CHANNELS = 3      # the published input channels, fed one grey crop


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v over (B, heads, N, head_dim), on
    :data:`SDPA_BACKEND` alone (an input it cannot take raises)."""
    attention.launches += 1
    attention.tokens += q.shape[0] * q.shape[2]
    with sdpa_kernel(SDPA_BACKEND):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


attention.launches = 0
attention.tokens = 0


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.proj = nn.Conv2d(PATCH_CHANNELS, cfg.embed_dim,
                              cfg.patch_size, stride=cfg.patch_size,
                              padding=cfg.patch_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, S, S) channels-last -> (B, grid * grid, D) tokens."""
        y = self.proj(x)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        with stage('attention'):
            o = attention(qkv[0], qkv[1], qkv[2], self.scale)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d, cfg.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = Mlp(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.grid * cfg.grid + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) channels-last -> (B, D, grid, grid) channels-last."""
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        g = self.cfg.grid
        return x.reshape(x.shape[0], g, g, x.shape[-1]).permute(0, 3, 1, 2)


class Head(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        layers, cin = [], cfg.embed_dim
        for c in cfg.head_channels:
            layers += [nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1,
                                          bias=False),
                       nn.BatchNorm2d(c), nn.ReLU(inplace=True)]
            cin = c
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, cfg.num_keypoints, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """The top-down model: ``backbone`` then ``keypoint_head``, its
    parameters and buffers in ``dtype``.  Serve it in eval mode."""

    def __init__(self, cfg: ViTPoseConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.backbone = ViT(cfg)
        self.keypoint_head = Head(cfg)
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 1) -> f32 (B, S/4, S/4, K)."""
        with stage('vit_encoder'):
            x = x.to(self.dtype).permute(0, 3, 1, 2).expand(
                -1, PATCH_CHANNELS, -1, -1).contiguous(
                memory_format=torch.channels_last)
            f = self.backbone(x)
        with stage('vit_head'):
            hm = self.keypoint_head(f)
            return hm.to(torch.float32).permute(0, 2, 3, 1)
