"""The plain reference of HRFormer-B (Yuan, Fu, Huang, Lin, Zhang, Chen and
Wang, "HRFormer: High-Resolution Transformer for Dense Prediction",
NeurIPS 2021, arXiv:2110.09408; mmpose's
``mmpose/models/backbones/hrformer.py`` and ``configs/body/
2d_kpt_sview_rgb_img/topdown_heatmap/coco/hrformer_base_coco_384x288.py``),
in plain PyTorch and float32 (TF32 off), written from the published
equations.  It imports nothing of the port.

* stem: 3x3 conv stride 2 (3 -> 64, no bias), BN, ReLU; 3x3 conv stride 2
  (64 -> 64), BN, ReLU;
* stage 1: two Bottlenecks of 64 planes, expansion 4 (the first with a
  1x1 conv + BN projection), ``relu(body + shortcut)``;
* transitions: a 3x3 conv + BN + ReLU, stride 1 where a branch keeps its
  resolution (and changes width), stride 2 from the last branch to a new
  one;
* stages 2, 3, 4: 1, 4 and 2 modules over 2, 3 and 4 branches of widths
  (78, 156, 312, 624) and heads (2, 4, 8, 16) of 39, each module 2 blocks
  a branch then the fusion.  A block on (B, C, H, W) as tokens:
  ``x += WMSA(LN1(x)); x += CrossFFN(LN2(x))``, LayerNorm eps 1e-6.
  WMSA: zeros centre-pad H and W to multiples of 7 (``pad // 2`` before),
  7x7 windows, ``qkv`` linear with bias, per head ``softmax(q k^T *
  39 ** -0.5 + B_rel) v`` written out, ``B_rel[h, i, j] = table[(y_i -
  y_j + 6) * 13 + (x_i - x_j + 6), h]``, ``proj`` linear, the windows
  put back and the padding cropped; the padded tokens are not masked.
  CrossFFN: 1x1 conv (C -> 4C, bias), BN, GELU; depthwise 3x3 (bias), BN,
  GELU; 1x1 conv (4C -> C, bias), BN, GELU (exact GELU).  Fusion i:
  ``relu(sum_j path_ij(x_j))``, j > i a 1x1 conv (no bias) + BN and a
  bilinear upsample by 2^(j-i) (half-pixel), j < i (i - j) steps of a
  depthwise 3x3 stride-2 conv + BN + 1x1 conv + BN, ReLU between steps;
  the last module fuses into branch 0 alone (nothing reads the others);
* head: a 1x1 conv with bias, 78 -> K, on branch 0: heatmaps at stride 4.

Departures from the published model, all of the configuration
(``configs/hrformer_b_serve.json``'s ``assumed``): the 3 input channels
are fed one grey crop, repeated; 30 heatmaps, not COCO's 17; a 512x512
input, not 384x288; seeded weights (:func:`seeded_state_dict`), not
trained ones, whose convs are drawn He-normal rather than mmpose's normal
of std 0.001 and whose final conv's std is raised.

Module names follow the port's tree (HRNet's Flax-style numbering, the
blocks' inner names mmpose's), so one state dict loads into both with
``strict=True``.

``FP8`` (:func:`fp8`) is the control of the correctness check, one
precision below the configuration's bf16: every linear and conv, and
both attention products, on e4m3 operands (each scaled by its largest
magnitude onto e4m3's range and rounded, as ``net.FP8`` does for the
HRNet's convs), multiplied in f32.
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
LN_EPS = 1e-6
BN_EPS = 1e-5


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


class Conv(nn.Conv2d):
    """A conv with padding k // 2."""

    def __init__(self, cin, cout, k, stride=1, bias=False, groups=1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=bias, groups=groups)

    def forward(self, x):
        return F.conv2d(_q(x), _q(self.weight), self.bias, self.stride,
                        self.padding, 1, self.groups)


class BatchNorm(nn.Module):
    """Eval BatchNorm: ``(x - mean) / sqrt(var + 1e-5) * weight + bias``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x):
        s = (self.weight / torch.sqrt(self.running_var + BN_EPS))
        return ((x - self.running_mean[:, None, None]) * s[:, None, None]
                + self.bias[:, None, None])


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, relu=True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, stride)
        self.BatchNorm_0 = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.relu else x


class SeparableConvBN(nn.Module):
    def __init__(self, cin, cout, relu):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, 3, 2, groups=cin)
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_1 = Conv(cin, cout, 1)
        self.BatchNorm_1 = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_1(self.Conv_1(self.BatchNorm_0(self.Conv_0(x))))
        return torch.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, planes, 1)
        self.ConvBN_1 = ConvBN(planes, planes, 3)
        self.ConvBN_2 = ConvBN(planes, 4 * planes, 1, relu=False)
        self.project = cin != 4 * planes
        if self.project:
            self.ConvBN_3 = ConvBN(cin, 4 * planes, 1, relu=False)

    def forward(self, x):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        return torch.relu(y + (self.ConvBN_3(x) if self.project else x))


def relative_position_index(window: int) -> torch.Tensor:
    """Swin's: mmseg's ``double_step_seq`` sum, flipped along the keys."""
    coords = (torch.arange(0, (2 * window - 1) * window, 2 * window - 1)
              [:, None] + torch.arange(window)[None, :]).reshape(1, -1)
    return (coords + coords.T).flip(1).contiguous()


class Attention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        ws = self.window
        ph = math.ceil(h / ws) * ws - h
        pw = math.ceil(w / ws) * ws - w
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        nh, nw = (h + ph) // ws, (w + pw) // ws
        x = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(-1, ws * ws, c)
        n = ws * ws
        q, k, v = self.qkv(x).reshape(-1, n, 3, self.heads,
                                      c // self.heads).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(n, n, -1)
        logits = (_q(q) @ _q(k).transpose(-2, -1)) * self.scale
        a = torch.softmax(logits + bias.permute(2, 0, 1)[None], dim=-1)
        o = (_q(a) @ _q(v)).transpose(1, 2).reshape(-1, n, c)
        o = self.proj(o).reshape(b, nh, nw, ws, ws, c)
        o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, h + ph, w + pw, c)
        return o[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]


class CrossFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Conv(dim, hidden, 1, bias=True)
        self.norm1 = BatchNorm(hidden)
        self.dw3x3 = Conv(hidden, hidden, 3, bias=True, groups=hidden)
        self.norm2 = BatchNorm(hidden)
        self.fc2 = Conv(hidden, dim, 1, bias=True)
        self.norm3 = BatchNorm(dim)

    def forward(self, x):
        x = F.gelu(self.norm1(self.fc1(x)))
        x = F.gelu(self.norm2(self.dw3x3(x)))
        return F.gelu(self.norm3(self.fc2(x)))


class HRFormerBlock(nn.Module):
    def __init__(self, dim, heads, window, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = CrossFFN(dim, dim * mlp_ratio)

    def forward(self, x):
        """x (B, C, H, W)."""
        t = x.permute(0, 2, 3, 1)
        t = t + self.attn(self.norm1(t))
        f = self.ffn(self.norm2(t).permute(0, 3, 1, 2))
        return t.permute(0, 3, 1, 2) + f


class Branch(nn.Module):
    def __init__(self, dim, blocks, heads, window, mlp_ratio):
        super().__init__()
        self.n = blocks
        for i in range(blocks):
            self.add_module(f'HRFormerBlock_{i}',
                            HRFormerBlock(dim, heads, window, mlp_ratio))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'HRFormerBlock_{i}')(x)
        return x


class Fuse(nn.Module):
    """``relu(sum_j path_ij(x_j))`` for outputs i < ``outputs``."""

    def __init__(self, chans, outputs):
        super().__init__()
        self.rows = []
        n_conv = n_sep = 0
        for i in range(outputs):
            row = []
            for j in range(len(chans)):
                steps = []
                if j > i:
                    name = f'ConvBN_{n_conv}'
                    n_conv += 1
                    self.add_module(name, ConvBN(chans[j], chans[i], 1,
                                                 relu=False))
                    steps.append(name)
                for s in range(i - j):
                    last = s == i - j - 1
                    name = f'SeparableConvBN_{n_sep}'
                    n_sep += 1
                    self.add_module(name, SeparableConvBN(
                        chans[j], chans[i] if last else chans[j],
                        relu=not last))
                    steps.append(name)
                row.append(steps)
            self.rows.append(row)

    def forward(self, xs):
        out = []
        for i, row in enumerate(self.rows):
            y = 0
            for j, steps in enumerate(row):
                p = xs[j]
                for name in steps:
                    p = getattr(self, name)(p)
                if j > i:
                    p = F.interpolate(p, scale_factor=2 ** (j - i),
                                      mode='bilinear', align_corners=False)
                y = y + p
            out.append(torch.relu(y))
        return out


class Module(nn.Module):
    def __init__(self, st: dict, outputs: int):
        super().__init__()
        self.n = len(st['channels'])
        for i, c in enumerate(st['channels']):
            self.add_module(f'BranchBlocks_{i}', Branch(
                c, st['blocks'], st['heads'][i], st['window'],
                st['mlp_ratio']))
        self.FuseLayer_0 = Fuse(st['channels'], outputs)

    def forward(self, xs):
        return self.FuseLayer_0([getattr(self, f'BranchBlocks_{i}')(x)
                                 for i, x in enumerate(xs)])


class Transition(nn.Module):
    def __init__(self, cin: list, cout: list):
        super().__init__()
        self.paths = []
        n = 0
        for i, c in enumerate(cout):
            steps = []
            if i < len(cin):
                if cin[i] != c:
                    steps.append((cin[i], c, 1))
            else:
                for j in range(i + 1 - len(cin)):
                    last = j == i - len(cin)
                    steps.append((cin[-1], c if last else cin[-1], 2))
            names = []
            for a, b, s in steps:
                self.add_module(f'ConvBN_{n}', ConvBN(a, b, 3, s))
                names.append(f'ConvBN_{n}')
                n += 1
            self.paths.append(names)
        self.n_in = len(cin)

    def forward(self, xs):
        out = []
        for i, names in enumerate(self.paths):
            y = xs[min(i, self.n_in - 1)]
            for name in names:
                y = getattr(self, name)(y)
            out.append(y)
        return out


def stages(cfg: dict) -> list[dict]:
    """Stages 2-4 of ``cfg``: modules, widths, heads, blocks a branch,
    window, MLP ratio."""
    return [dict(modules=m, channels=cfg['channels'][:n],
                 heads=cfg['heads'][:n], blocks=cfg['blocks_per_branch'],
                 window=cfg['window'], mlp_ratio=cfg['mlp_ratio'])
            for n, m in zip((2, 3, 4), cfg['modules'])]


class HRFormer(nn.Module):
    """(B, S, S, 1) normalised grey crops -> (B, S/4, S/4, K) f32
    heatmaps, :data:`FRAMES_PER_BLOCK` frames at a time.  Use in eval
    mode."""

    def __init__(self, cfg: dict):
        super().__init__()
        stem = cfg['stem_channels']
        self.ConvBN_0 = ConvBN(3, stem, 3, 2)
        self.ConvBN_1 = ConvBN(stem, stem, 3, 2)
        self.BranchBlocks_0 = nn.Module()
        cin = stem
        for i in range(cfg['stage1_blocks']):
            self.BranchBlocks_0.add_module(
                f'Bottleneck_{i}', Bottleneck(cin, cfg['stage1_planes']))
            cin = 4 * cfg['stage1_planes']
        self.n_stage1 = cfg['stage1_blocks']
        self.layout = []
        chans, n_mod = [cin], 0
        sts = stages(cfg)
        for t, st in enumerate(sts):
            self.add_module(f'Transition_{t}',
                            Transition(chans, st['channels']))
            chans = st['channels']
            mods = []
            for m in range(st['modules']):
                last = t == len(sts) - 1 and m == st['modules'] - 1
                self.add_module(f'HRModule_{n_mod}',
                                Module(st, 1 if last else len(chans)))
                mods.append(f'HRModule_{n_mod}')
                n_mod += 1
            self.layout.append((f'Transition_{t}', mods))
        self.final_layer = Conv(chans[0], cfg['num_keypoints'], 1, bias=True)

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
        x = self.ConvBN_1(self.ConvBN_0(x))
        for i in range(self.n_stage1):
            x = getattr(self.BranchBlocks_0, f'Bottleneck_{i}')(x)
        xs = [x]
        for trans, mods in self.layout:
            xs = getattr(self, trans)(xs)
            for name in mods:
                xs = getattr(self, name)(xs)
        return self.final_layer(xs[0]).permute(0, 2, 3, 1)


def stride(cfg: dict) -> int:
    """Crop pixels per heatmap pixel: the stem's two stride-2 convs."""
    return 4


def padded_tokens(cfg: dict) -> list[int]:
    """Tokens a frame of each branch, its side padded to whole windows."""
    w = cfg['window']
    return [(math.ceil(cfg['crop_size'] // 4 // 2 ** i / w) * w) ** 2
            for i in range(len(cfg['channels']))]


def blocks_per_branch(cfg: dict) -> list[int]:
    """HRFormer blocks of each branch over stages 2-4."""
    out = [0] * len(cfg['channels'])
    for st in stages(cfg):
        for i in range(len(st['channels'])):
            out[i] += st['modules'] * st['blocks']
    return out


@torch.no_grad()
def seeded_state_dict(cfg: dict, generator: torch.Generator
                      ) -> dict[str, torch.Tensor]:
    """Published-style initialisation, drawn on ``generator``'s device in
    f32: linears and the bias tables truncated normal of std 0.02 (within
    +-2, timm's ``trunc_normal_``), linear biases 0; LayerNorm and
    BatchNorm 1 and 0, running mean 0 and variance 1; the relative-
    position index as built; every conv He-normal (std sqrt(2 / fan in)),
    its bias 0, but the final conv normal of std ``cfg['head_final_std']``
    (the scale at which the heatmaps' maxima straddle the 0.6 threshold).
    mmpose draws the convs normal of std 0.001: with BatchNorm's identity
    statistics that leaves the stem's signal far under LayerNorm's eps,
    and every softmax uniform."""
    dev = generator.device
    with torch.device('meta'):
        model = HRFormer(cfg)
        shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    out = {}
    for name, (shape, dtype) in shapes.items():
        leaf = name.rsplit('.', 1)[-1]
        parent = name.rsplit('.', 2)[-2] if '.' in name else ''
        if leaf == 'relative_position_index':
            out[name] = relative_position_index(
                cfg['window']).to(dev)
            continue
        t = torch.empty(shape, dtype=dtype, device=dev)
        if leaf == 'relative_position_bias_table' or (
                parent in ('qkv', 'proj') and leaf == 'weight'):
            nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                  generator=generator)
        elif name == 'final_layer.weight':
            t.normal_(0.0, cfg['head_final_std'], generator=generator)
        elif leaf == 'weight' and t.dim() == 4:
            t.normal_(0.0, math.sqrt(2.0 / math.prod(shape[1:])),
                      generator=generator)
        elif leaf in ('weight', 'running_var'):     # LayerNorm, BatchNorm
            t.fill_(1.0)
        else:           # biases, running means
            t.zero_()
        out[name] = t
    return out
