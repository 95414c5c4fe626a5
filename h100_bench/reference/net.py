"""The plain reference network: HRNet-W32 with CBAM in every block, as the
reference's ``models/seg_hrnet3.py`` (``get_seg_model``) defines it, in
plain PyTorch modules.

A frozen copy of the port's plain path (``models/layers.py`` and
``models/hrnet.py``) with its kernels, levers and mesh code left out: no
fused CBAM, no int8 head, no merged fuse, no split convs.  It imports
nothing of the port.  Module names follow the Flax auto-numbering, so the
r5 artifact's leaves map onto it one by one (``weights.py``).

Parameters are f32 masters; each :class:`Conv` computes in ``dtype`` (bf16
for the configurations of this benchmark), casting its input, kernel and
bias at use; BatchNorm computes in f32, then ReLU, then the cast back.

``FP8`` turns every convolution into one on float8 (e4m3) operands: the
input and the kernel are each scaled by their largest magnitude onto
e4m3's range, rounded to it, and multiplied in ``dtype`` with an f32
accumulation, which is exact for e4m3 products.  It is the control of the
correctness check, one precision below the configuration's bf16 (the
gradient passes straight through the rounding).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

FP8 = False
_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, in ``x``'s dtype."""
    with torch.no_grad():
        scale = x.detach().abs().amax().to(torch.float32).clamp(
            min=1e-12) / _E4M3_MAX
        q = ((x.to(torch.float32) / scale).to(torch.float8_e4m3fn)
             .to(torch.float32) * scale).to(x.dtype)
    return x + (q - x).detach()


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(in_size: int, out_size: int,
                          device: torch.device) -> torch.Tensor:
    if out_size == 1 or in_size == 1:
        m = torch.zeros((out_size, in_size), dtype=torch.float32,
                        device=device)
        m[:, 0] = 1.0
        return m
    pos = torch.arange(out_size, dtype=torch.float32, device=device) \
        * ((in_size - 1) / (out_size - 1))
    idx = torch.arange(in_size, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - (idx - pos[:, None]).abs(), min=0.0)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW maps: half-pixel centres
    (``F.interpolate``), or ``align_corners`` as two tent-weight products
    with the weights cast to the activation dtype, as the reference's
    ``nn.UpsamplingBilinear2d`` runs in bf16."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if not align_corners:
        return F.interpolate(x, size=(oh, ow), mode='bilinear',
                             align_corners=False)
    wy = _align_corners_matrix(h, oh, x.device).to(x.dtype)
    wx = _align_corners_matrix(w, ow, x.device).to(x.dtype)
    rows = torch.einsum('oh,nhwc->nowc', wy, x.permute(0, 2, 3, 1))
    out = torch.einsum('pw,nowc->nopc', wx, rows)
    return out.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """Flax's BatchNorm in f32 (eps 1e-5): running statistics in eval
    mode; in training the batch mean and ``E[x^2] - E[x]^2`` clipped at 0,
    the running ones updated as ``m * running + (1 - m) * batch``."""

    def __init__(self, channels: int, momentum: float = 0.99):
        super().__init__()
        self.eps = 1e-5
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class Conv(nn.Conv2d):
    """A conv with f32 parameters computing in ``dtype``; padding
    ``k // 2`` on both sides."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype=torch.bfloat16):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        if FP8:
            x, w = fp8_round(x), fp8_round(w)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, w, bias, self.stride, self.padding)


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, dtype=torch.bfloat16,
                 bn_momentum: float = 0.99):
        super().__init__()
        self.relu, self.dtype = relu, dtype
        self.Conv_0 = Conv(cin, features, kernel, stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.relu:
            x = torch.relu(x)
        return x.to(self.dtype)


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        hidden = max(channels // 16, 1)
        self.Conv_0 = Conv(channels, hidden, 1, dtype=dtype)
        self.Conv_1 = Conv(hidden, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        y = self.Conv_1(torch.relu(self.Conv_0(torch.cat([avg, mx], 0))))
        b = x.shape[0]
        return torch.sigmoid(y[:b] + y[b:])


class SpatialAttention(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(2, 1, 7, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.Conv_0(s))


class CBAM(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ChannelAttention_0 = ChannelAttention(channels, dtype=dtype)
        self.SpatialAttention_0 = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        x_g = self.ChannelAttention_0(x) * x
        x_g = self.SpatialAttention_0(x_g) * x_g
        if residual is None:
            return x_g
        return torch.relu(x_g + residual).to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, with_cbam: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(cin, features, 3, 1, dtype=dtype,
                               bn_momentum=0.9)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False,
                               dtype=dtype, bn_momentum=0.9)
        self.downsample = cin != features
        if self.downsample:
            self.ConvBN_2 = ConvBN(cin, features, 1, 1, relu=False,
                                   dtype=dtype)
        self.CBAM_0 = CBAM(features, dtype=dtype) if with_cbam else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBN_1(self.ConvBN_0(x))
        residual = self.ConvBN_2(x) if self.downsample else x
        if self.CBAM_0 is not None:
            return self.CBAM_0(out, residual)
        return torch.relu(out + residual).to(self.dtype)


class BranchBlocks(nn.Module):
    def __init__(self, num_blocks: int, cin: int, features: int,
                 with_cbam: bool, dtype=torch.bfloat16):
        super().__init__()
        self.names = []
        for i in range(num_blocks):
            self.add_module(f'BasicBlock_{i}', BasicBlock(
                cin, features, with_cbam=with_cbam, dtype=dtype))
            self.names.append(f'BasicBlock_{i}')
            cin = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class FuseLayer(nn.Module):
    """Cross-resolution fusion: for output i and input j, j > i a 1x1
    ConvBN then the upsample, j < i (i - j) strided 3x3 ConvBNs; the sum
    through ReLU."""

    def __init__(self, channels: tuple[int, ...], dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.paths: list[list[list[str]]] = []
        n = 0
        for i in range(len(channels)):
            row = []
            for j in range(len(channels)):
                chain = []
                if j > i:
                    specs = [(channels[j], channels[i], 1, 1, False)]
                elif j < i:
                    specs = [(channels[j],
                              channels[i] if k == i - j - 1 else channels[j],
                              3, 2, k != i - j - 1) for k in range(i - j)]
                else:
                    specs = []
                for cin, cout, kernel, stride, relu in specs:
                    self.add_module(f'ConvBN_{n}', ConvBN(
                        cin, cout, kernel, stride, relu=relu, dtype=dtype))
                    chain.append(f'ConvBN_{n}')
                    n += 1
                row.append(chain)
            self.paths.append(row)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i, row in enumerate(self.paths):
            y = None
            for j, chain in enumerate(row):
                path = xs[j]
                for name in chain:
                    path = getattr(self, name)(path)
                if j > i:
                    path = resize_bilinear(path, tuple(xs[i].shape[2:4]))
                y = path if y is None else y + path
            outs.append(torch.relu(y).to(self.dtype))
        return outs


class HRModule(nn.Module):
    def __init__(self, num_blocks: tuple[int, ...], channels: tuple[int, ...],
                 with_cbam: bool, dtype=torch.bfloat16):
        super().__init__()
        self.n = len(channels)
        for i in range(self.n):
            self.add_module(f'BranchBlocks_{i}', BranchBlocks(
                num_blocks[i], channels[i], channels[i], with_cbam,
                dtype=dtype))
        if self.n > 1:
            self.FuseLayer_0 = FuseLayer(channels, dtype=dtype)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        xs = [getattr(self, f'BranchBlocks_{i}')(x) for i, x in enumerate(xs)]
        return xs if self.n == 1 else self.FuseLayer_0(xs)


class Transition(nn.Module):
    def __init__(self, cin: tuple[int, ...], cout: tuple[int, ...],
                 dtype=torch.bfloat16):
        super().__init__()
        self.n_pre = len(cin)
        self.paths: list[list[str]] = []
        n = 0
        for i, ch in enumerate(cout):
            chain = []
            if i < self.n_pre:
                if cin[i] != ch:
                    chain.append((cin[i], ch, 1))
            else:
                c = cin[-1]
                for j in range(i + 1 - self.n_pre):
                    out_ch = ch if j == i - self.n_pre else cin[-1]
                    chain.append((c, out_ch, 2))
                    c = out_ch
            names = []
            for a, b, stride in chain:
                self.add_module(f'ConvBN_{n}', ConvBN(a, b, 3, stride,
                                                      dtype=dtype))
                names.append(f'ConvBN_{n}')
                n += 1
            self.paths.append(names)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i, names in enumerate(self.paths):
            y = xs[i] if i < self.n_pre else xs[-1]
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return outs


class HRNet(nn.Module):
    """(B, H, W, in_channels) -> f32 (B, H, W, K) heatmaps.

    ``widths``: the channels of the four stages' branches (stage s has
    s + 1 branches; stage 1 one); ``blocks``: BasicBlocks per branch in
    stages 1 to 4; one module per stage."""

    def __init__(self, in_channels: int = 1, num_keypoints: int = 30,
                 stem_channels: int = 64,
                 widths: tuple[int, ...] = (32, 64, 128, 256),
                 blocks: tuple[int, ...] = (2, 2, 2, 4),
                 with_cbam: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv1 = Conv(in_channels, stem_channels, 3, dtype=dtype)
        self.stem_bn1 = BatchNorm(stem_channels)
        self.ConvBN_0 = ConvBN(stem_channels, stem_channels, 3, 2,
                               dtype=dtype)
        self.BranchBlocks_0 = BranchBlocks(blocks[0], stem_channels,
                                           widths[0], with_cbam, dtype=dtype)
        chans = (widths[0],)
        self.stages = []
        for t in range(3):
            out = tuple(widths[:t + 2])
            self.add_module(f'Transition_{t}', Transition(chans, out,
                                                          dtype=dtype))
            self.add_module(f'HRModule_{t}', HRModule(
                (blocks[t + 1],) * len(out), out, with_cbam, dtype=dtype))
            self.stages.append((f'Transition_{t}', f'HRModule_{t}'))
            chans = out
        total = sum(chans)
        self.ConvBN_1 = ConvBN(total, total, 3, 1, dtype=dtype)
        self.ConvBN_2 = ConvBN(total, num_keypoints, 1, 1, dtype=dtype)
        self.CBAM_0 = CBAM(stem_channels, dtype=dtype)
        self.output_conv = Conv(num_keypoints + stem_channels, num_keypoints,
                                3, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw_in = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        stem = self.stem_conv1(raw_in)
        x = torch.relu(self.stem_bn1(stem)).to(self.dtype)
        xs = [self.BranchBlocks_0(self.ConvBN_0(x))]
        for trans, mod in self.stages:
            xs = getattr(self, mod)(getattr(self, trans)(xs))
        h0, w0 = xs[0].shape[2:4]
        total = torch.cat([xs[0]] + [resize_bilinear(b, (h0, w0))
                                     for b in xs[1:]], 1)
        total = self.ConvBN_2(self.ConvBN_1(total))
        total = resize_bilinear(total, tuple(raw_in.shape[2:4]),
                                align_corners=True)
        skip = resize_bilinear(self.CBAM_0(stem), tuple(total.shape[2:4]),
                               align_corners=True)
        out = self.output_conv(torch.cat([total, skip], 1))
        return out.to(torch.float32).permute(0, 2, 3, 1)
