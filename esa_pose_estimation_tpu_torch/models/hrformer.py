"""HRFormer: HRNet's parallel multi-resolution modules with transformer
blocks in their branches (Yuan, Fu, Huang, Lin, Zhang, Chen and Wang,
"HRFormer: High-Resolution Transformer for Dense Prediction", NeurIPS
2021, arXiv:2110.09408; github.com/HRNet/HRFormer, and mmpose's
``mmpose/models/backbones/hrformer.py`` with ``configs/body/
2d_kpt_sview_rgb_img/topdown_heatmap/coco/hrformer_base_coco_384x288.py``).

* stem: two 3x3 convs of stride 2 (3 -> 64 -> 64, no bias), each with
  BatchNorm and ReLU, to 1/4 of the input;
* stage 1: Bottlenecks of 64 planes (256 channels out), no CBAM;
* stages 2-4: HRNet's transitions and multi-resolution modules
  (``models/hrnet.Transition``, ``HRModule``), whose branches are
  :class:`HRFormerBlock` s and whose fusions downsample by depthwise-
  separable steps (``models/layers.SeparableConvBN``); the last module
  fuses into branch 0 alone, the only output the head reads;
* head: a 1x1 conv with bias on branch 0 (mmpose's
  ``TopdownHeatmapSimpleHead`` with no deconvs), heatmaps at stride 4.

An :class:`HRFormerBlock` takes (B, C, H, W) as (B, H, W, C) tokens:
``x += WMSA(LN1(x))`` then ``x += CrossFFN(LN2(x))``, LayerNorm eps 1e-6,
drop-path the identity.  WMSA (:class:`WindowAttention`) centre-pads H and
W with zeros up to multiples of the window, attends within each 7x7
window, ``softmax(q k^T / sqrt(head_dim) + B_rel) v`` with Swin's
relative-position bias ``B_rel[h, i, j] = table[(y_i - y_j + 6) * 13 +
(x_i - x_j + 6), h]``, and crops the padding away; the padded tokens take
part in every softmax (mmpose's ``with_pad_mask=False``).  CrossFFN is
1x1 conv -> BN -> GELU, depthwise 3x3 conv -> BN -> GELU, 1x1 conv -> BN
-> GELU (exact GELU, convs with bias, eval BatchNorm).

:class:`HRFormer` takes ``(B, S, S, 1)`` normalised grey crops, as
``pipeline.infer_poses_from_crops`` hands them over, repeats the grey
channel into the published three, and returns f32 ``(B, S/4, S/4, K)``
channels-last heatmaps.  The convs and BatchNorms are HRNet's
(``models/layers.Conv``: f32 masters cast to the model dtype at use,
``store_in_compute_dtype`` for the serving form; BatchNorm in f32); each
block's LayerNorms, linears and bias table are held in the model dtype,
as ViTPose's are.  Activations are channels-last.

The attention core is ``models/vitpose.attention``, the port's SDPA
wrapper (which counts calls and query tokens), on :data:`SDPA_BACKENDS`'
backend for the tensors' device: on the card PyTorch's memory-efficient
kernel, which takes the additive bias (flash takes none), on the CPU its
flash kernel, which takes it there.  The kernel wants a head dimension in
multiples of :data:`HEAD_ALIGN`: q, k and v are zero-padded from 39 to
40, which changes no product (the scale stays 39 ** -0.5), and the
output's padding column (zeros) is dropped.  The bias table's rows are
laid out at a stride of 16 elements, so the kernel reads it in place
rather than padding a copy per window.

Each forward runs the recorder's stages (``obs/profiling.stage``)
``attention`` around each block's attention core and ``fuse`` around each
module's fusion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend

from esa_pose_estimation_tpu_torch.models.hrnet import BranchBlocks, add_stages
from esa_pose_estimation_tpu_torch.models.layers import (
    BLOCKS,
    BatchNorm,
    Conv,
    ConvBN,
)
from esa_pose_estimation_tpu_torch.models.vitpose import (
    PATCH_CHANNELS,
    attention,
)
from esa_pose_estimation_tpu_torch.obs.profiling import stage
from esa_pose_estimation_tpu_torch.utils.config import HRFormerConfig

# the attention core's backend by device type (an input it cannot take
# raises): memory-efficient on the card, flash on the CPU, both with bias
SDPA_BACKENDS = {'cuda': SDPBackend.EFFICIENT_ATTENTION,
                 'cpu': SDPBackend.FLASH_ATTENTION}
HEAD_ALIGN = 8          # head dimensions the kernel takes: multiples of 8
BIAS_ALIGN = 16         # the bias rows' stride the kernel reads in place
LN_EPS = 1e-6


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2) int64: Swin's index into the bias table,
    ``(y_i - y_j + w - 1) * (2w - 1) + (x_i - x_j + w - 1)`` for tokens i,
    j of a window laid out row-major."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing='ij')
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def window_pad(h: int, w: int, window: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) zeros that centre an (h, w) map in
    whole windows: ``pad = ceil(h / window) * window - h``, ``pad // 2``
    before and the rest after."""
    ph, pw = -h % window, -w % window
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


class WindowAttention(nn.Module):
    """WMSA over (B, H, W, C) tokens (see the module's docstring)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def bias(self) -> torch.Tensor:
        """(1, heads, n, n) relative-position bias, its rows at a stride of
        :data:`BIAS_ALIGN` elements."""
        n = self.window ** 2
        b = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        b = b.reshape(n, n, self.num_heads).permute(2, 0, 1)
        return F.pad(b, (0, -n % BIAS_ALIGN))[None, ..., :n]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, heads, hd = self.window, self.num_heads, self.head_dim
        top, bottom, left, right = window_pad(h, w, ws)
        x = F.pad(x, (0, 0, left, right, top, bottom))
        nh, nw, n = (h + top + bottom) // ws, (w + left + right) // ws, ws * ws
        x = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b * nh * nw, n, c)
        qkv = self.qkv(x).reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qkv = F.pad(qkv, (0, -hd % HEAD_ALIGN))
        bias = self.bias()
        with stage('attention'):
            o = attention(qkv[0], qkv[1], qkv[2], self.scale,
                          SDPA_BACKENDS[x.device.type], bias=bias)
        o = self.proj(o[..., :hd].transpose(1, 2).reshape(-1, n, c))
        o = o.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        o = o.reshape(b, nh * ws, nw * ws, c)
        return o[:, top:top + h, left:left + w]


class CrossFFN(nn.Module):
    """1x1 conv -> BN -> GELU, depthwise 3x3 -> BN -> GELU, 1x1 -> BN ->
    GELU on (B, H, W, C) tokens, as (B, C, H, W) channels-last maps."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Conv(dim, hidden, 1, bias=True, dtype=dtype)
        self.norm1 = BatchNorm(hidden)
        self.dw3x3 = Conv(hidden, hidden, 3, bias=True, dtype=dtype,
                          groups=hidden)
        self.norm2 = BatchNorm(hidden)
        self.fc2 = Conv(hidden, dim, 1, bias=True, dtype=dtype)
        self.norm3 = BatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv, norm in ((self.fc1, self.norm1), (self.dw3x3, self.norm2),
                           (self.fc2, self.norm3)):
            x = F.gelu(norm(conv(x))).to(self.dtype)
        return x.permute(0, 2, 3, 1)


class HRFormerBlock(nn.Module):
    """``x += WMSA(LN1(x)); x += CrossFFN(LN2(x))`` on (B, C, H, W)
    channels-last maps; a branch block of ``models/hrnet.BranchBlocks``
    (``block='HRFORMER'``, registered in ``models/layers.BLOCKS`` below),
    so it keeps the residual blocks' signature."""
    expansion = 1

    def __init__(self, cin: int, features: int, with_cbam: bool = False,
                 dtype=torch.float32, num_heads: int = 1,
                 window_size: int = 7, mlp_ratio: int = 4):
        super().__init__()
        if cin != features or with_cbam:
            raise ValueError('an HRFormer block keeps its width and has no '
                             'CBAM')
        self.norm1 = nn.LayerNorm(cin, eps=LN_EPS, dtype=dtype)
        self.attn = WindowAttention(cin, num_heads, window_size).to(dtype)
        self.norm2 = nn.LayerNorm(cin, eps=LN_EPS, dtype=dtype)
        self.ffn = CrossFFN(cin, cin * mlp_ratio, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.permute(0, 2, 3, 1)
        t = t + self.attn(self.norm1(t))
        t = t + self.ffn(self.norm2(t))
        return t.permute(0, 3, 1, 2)


BLOCKS['HRFORMER'] = HRFormerBlock


class HRFormer(nn.Module):
    """The top-down model (see the module's docstring): (B, S, S, 1) ->
    f32 (B, S/4, S/4, K).  Serve it in eval mode."""

    def __init__(self, cfg: HRFormerConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c, s1 = cfg, cfg.stage1
        self.ConvBN_0 = ConvBN(PATCH_CHANNELS, c.stem_channels, 3, 2,
                               dtype=dtype)
        self.ConvBN_1 = ConvBN(c.stem_channels, c.stem_channels, 3, 2,
                               dtype=dtype)
        self.BranchBlocks_0 = BranchBlocks(s1.block, s1.num_blocks[0],
                                           c.stem_channels,
                                           s1.num_channels[0], False,
                                           dtype=dtype)
        self.stage_names, chans = add_stages(
            self, (c.stage2, c.stage3, c.stage4),
            (s1.num_channels[0] * BLOCKS[s1.block].expansion,), False,
            dtype, separable=True, last_outputs=1)
        self.final_layer = Conv(chans[0], c.num_keypoints, 1, bias=True,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 1) -> f32 (B, S/4, S/4, K)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).expand(
            -1, PATCH_CHANNELS, -1, -1).contiguous(
            memory_format=torch.channels_last)
        x = self.ConvBN_1(self.ConvBN_0(x))
        xs = [self.BranchBlocks_0(x)]
        for trans, mods in self.stage_names:
            xs = getattr(self, trans)(xs)
            for name in mods:
                module = getattr(self, name)
                xs = module.branches(xs)
                with stage('fuse'):
                    xs = module.fuse(xs)
        hm = self.final_layer(xs[0])
        return hm.to(torch.float32).permute(0, 2, 3, 1)
