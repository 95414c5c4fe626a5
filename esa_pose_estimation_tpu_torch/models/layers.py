"""Shared model building blocks (torch port of the JAX package's
``models/layers.py``; reference: seg_hrnet3.py:26-145).

Internally the network runs NCHW tensors; the serving model keeps them in
``torch.channels_last`` memory, so an NHWC view of any activation is free.
Convolutions compute in the model dtype (bf16 for serving) with weights
stored in that dtype; BatchNorm computes in f32 from f32 statistics, then
ReLU, then casts back to the model dtype, as the reference does.

Submodule attribute names follow the Flax auto-numbering of the JAX model
(``ConvBN_0``, ``BasicBlock_1``, ``CBAM_0``, ...), so a trained JAX
parameter tree maps leaf by leaf onto this module tree
(``utils/artifact.from_jax_variables``).

Inference only: BatchNorm always normalizes with its running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import fused_cbam
from esa_pose_estimation_tpu_torch.experimental.int8_head import (
    int8_conv,
    quantize_weights_per_channel,
)


def _interp_matrix(samples: torch.Tensor, in_size: int) -> torch.Tensor:
    idx = torch.arange(in_size, dtype=samples.dtype, device=samples.device)
    return torch.clamp(1.0 - (idx - samples[..., None]).abs(), min=0.0)


def _align_corners_matrix(in_size: int, out_size: int,
                          device: torch.device) -> torch.Tensor:
    """(out, in) f32 tent weights sampling i * (in-1)/(out-1)."""
    if out_size == 1 or in_size == 1:
        m = torch.zeros((out_size, in_size), dtype=torch.float32,
                        device=device)
        m[:, 0] = 1.0
        return m
    pos = torch.arange(out_size, dtype=torch.float32, device=device) \
        * ((in_size - 1) / (out_size - 1))
    return _interp_matrix(pos, in_size)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW maps.

    ``align_corners=False`` is ``jax.image.resize`` (half-pixel centers).
    The network only upsamples here (by 2, 4 or 8), where its renormalized
    border taps equal ``F.interpolate``'s clamped ones.
    ``align_corners=True`` (``nn.UpsamplingBilinear2d``) runs as two
    tent-weight products with the weights cast to the activation dtype, as
    the reference does, so bf16 rounds the weights the same way.
    """
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if not align_corners:
        return F.interpolate(x, size=(oh, ow), mode='bilinear',
                             align_corners=False)
    dt = x.dtype if x.is_floating_point() else torch.float32
    wy = _align_corners_matrix(h, oh, x.device).to(dt)
    wx = _align_corners_matrix(w, ow, x.device).to(dt)
    nhwc = x.permute(0, 2, 3, 1)
    rows = torch.einsum('oh,nhwc->nowc', wy, nhwc)
    out = torch.einsum('pw,nowc->nopc', wx, rows)
    return out.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """Inference BatchNorm in f32 (eps 1e-5):
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, Flax's op order."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean[:, None, None]) \
            * mul[:, None, None]
        return y + self.bias[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          bias: bool = False, dtype=torch.float32) -> nn.Conv2d:
    # integer padding k//2 on both sides, the stride-2 convs included
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=bias, dtype=dtype)


# Serving-time int8 dispatch of the ConvBNs built with ``int8_serving=True``
# (the flagship head conv; experimental/int8_head.py).  Module-level so
# tests and chip_smoke.py can force either path.  Default False, as in the
# JAX package: ``cli/eval_synthetic --int8`` is its accuracy gate.
INT8_SERVING: bool = False


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm (f32) [+ ReLU], cast to the model dtype.

    ``int8_serving=True`` marks it for the int8 path (with ``INT8_SERVING``
    set and the module not training): per-channel int8 weights times
    per-sample int8 activations, int32 accumulation, dequantized, then the
    frozen-BN affine in f32.  The parameters are the same either way.
    """

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, dtype=torch.float32,
                 int8_serving: bool = False):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.stride = stride
        self.int8_serving = int8_serving
        self.Conv_0 = _conv(cin, features, kernel, stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Conv_0.weight.to(torch.float32).permute(2, 3, 1, 0)  # HWIO
        w_q, s_w = quantize_weights_per_channel(w)
        y = int8_conv(x.permute(0, 2, 3, 1), w_q, s_w, stride=self.stride)
        bn = self.BatchNorm_0
        inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        y = (y - bn.running_mean) * inv + bn.bias
        if self.relu:
            y = torch.relu(y)
        return y.to(self.dtype).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_serving and INT8_SERVING and not self.training:
            return self._int8_forward(x)
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.relu:
            x = torch.relu(x)
        return x.to(self.dtype)


class ChannelAttention(nn.Module):
    """CBAM channel gate: sigmoid(MLP(avgpool) + MLP(maxpool)), shared
    C -> C/16 -> C 1x1-conv MLP without bias (seg_hrnet3.py:32-47)."""

    def __init__(self, channels: int, ratio: int = 16, dtype=torch.float32):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.Conv_0 = _conv(channels, hidden, 1, dtype=dtype)
        self.Conv_1 = _conv(hidden, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        # one MLP pass over both pooled vectors stacked on the batch axis
        y = self.Conv_1(torch.relu(self.Conv_0(torch.cat([avg, mx], 0))))
        b = x.shape[0]
        return torch.sigmoid(y[:b] + y[b:])


class SpatialAttention(nn.Module):
    """CBAM spatial gate: sigmoid(conv7x7([mean_c, max_c]))
    (seg_hrnet3.py:49-61)."""

    def __init__(self, kernel: int = 7, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = _conv(2, 1, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.Conv_0(s))


# Serving-time dispatch of CBAM to the fused kernel
# (experimental/cbam_fuse.py).  Module-level so tests and chip_smoke.py can
# force either path.  Default False, as in the JAX package; whether it
# should serve by default on the card is decided by H100 measurement.
FUSED_CBAM: bool = False


class CBAM(nn.Module):
    """Channel + spatial gate, optionally fused with the residual tail.

    ``forward(x)`` returns the gated map (the attended stem skip);
    ``forward(x, residual)`` also applies the block tail
    ``relu(gated + residual)`` (seg_hrnet3.py:95-97).  With ``FUSED_CBAM``
    set and the module not training, the whole tail is one call of the
    fused kernel's wrapper (the kernel on CUDA, its plain version on CPU).
    """

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ChannelAttention_0 = ChannelAttention(channels, dtype=dtype)
        self.SpatialAttention_0 = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if FUSED_CBAM and not self.training:
            ca = self.ChannelAttention_0
            fc1 = ca.Conv_0.weight[:, :, 0, 0].t()               # (C, C/16)
            fc2 = ca.Conv_1.weight[:, :, 0, 0].t()               # (C/16, C)
            spw = self.SpatialAttention_0.Conv_0.weight[0].permute(1, 2, 0)
            res = (None if residual is None
                   else residual.permute(0, 2, 3, 1).contiguous())
            out = fused_cbam(x.permute(0, 2, 3, 1).contiguous(), fc1, fc2,
                             spw, res)
            return out.permute(0, 3, 1, 2)
        x_g = self.ChannelAttention_0(x) * x
        x_g = self.SpatialAttention_0(x_g) * x_g
        if residual is None:
            return x_g
        return torch.relu(x_g + residual).to(self.dtype)


class BasicBlock(nn.Module):
    """Residual basic block [+ CBAM] (seg_hrnet3.py:63-99)."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 with_cbam: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(cin, features, 3, stride, dtype=dtype)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False,
                               dtype=dtype)
        self.downsample = stride != 1 or cin != features
        if self.downsample:
            self.ConvBN_2 = ConvBN(cin, features, 1, stride, relu=False,
                                   dtype=dtype)
        self.CBAM_0 = CBAM(features, dtype=dtype) if with_cbam else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBN_1(self.ConvBN_0(x))
        residual = self.ConvBN_2(x) if self.downsample else x
        if self.CBAM_0 is not None:
            return self.CBAM_0(out, residual)
        return torch.relu(out + residual).to(self.dtype)


class Bottleneck(nn.Module):
    """Residual bottleneck [+ CBAM] (seg_hrnet3.py:102-145)."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 with_cbam: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = features * 4
        self.ConvBN_0 = ConvBN(cin, features, 1, 1, dtype=dtype)
        self.ConvBN_1 = ConvBN(features, features, 3, stride, dtype=dtype)
        self.ConvBN_2 = ConvBN(features, out_ch, 1, 1, relu=False,
                               dtype=dtype)
        self.downsample = stride != 1 or cin != out_ch
        if self.downsample:
            self.ConvBN_3 = ConvBN(cin, out_ch, 1, stride, relu=False,
                                   dtype=dtype)
        self.CBAM_0 = CBAM(out_ch, dtype=dtype) if with_cbam else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        residual = self.ConvBN_3(x) if self.downsample else x
        if self.CBAM_0 is not None:
            return self.CBAM_0(out, residual)
        return torch.relu(out + residual).to(self.dtype)


BLOCKS: dict[str, type[nn.Module]] = {
    'BASIC': BasicBlock,
    'BOTTLENECK': Bottleneck,
}
