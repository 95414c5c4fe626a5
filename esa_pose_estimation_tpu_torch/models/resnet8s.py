"""Dilated ResNet-8s keypoint networks, PVNet style (torch port of the JAX
package's ``models/resnet8s.py``; reference net.py:7-155 ``Resnet18_8s`` /
``Resnet50_8s`` over the dilated backbone of resnet.py:116-221).

A ResNet backbone with output stride 8 (layers 3 and 4 use stride 1 with
dilation 2 and 4), then a decoder that upsamples 8s -> 4s -> 2s -> full
resolution (align-corners bilinear) with skip concatenations, emitting
``ver_dim`` channels.  Inputs and outputs are NHWC at the module boundary;
inside, NCHW tensors in ``torch.channels_last`` memory, so the channels-last
output is contiguous as the peak-decode kernel reads it.

Submodule names follow the Flax auto-numbering of the JAX modules
(``ResNetBackbone8s_0`` with ``Conv_0``/``BatchNorm_0``, ``ResBlock_*`` or
``ResBottleneck_*``, ``ConvBN_0``; ``ConvBNLeaky_0..3``; the head
``Conv_0``), so ``utils/artifact.from_jax_variables`` maps a JAX variable
tree onto them leaf by leaf.  Every BatchNorm runs at Flax momentum 0.9
(torch's default 0.1 in the reference, resnet.py:189).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvBN,
    lecun_normal_,
    resize_bilinear,
)
from esa_pose_estimation_tpu_torch.ops.vertex import vertex_loss

_MOMENTUM = 0.9


class ResBlock(nn.Module):
    """Basic residual block (no CBAM) with optional dilation."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, features, 3, stride, dtype=dtype,
                           dilation=dilation)
        self.BatchNorm_0 = BatchNorm(features, momentum=_MOMENTUM)
        self.Conv_1 = Conv(features, features, 3, dtype=dtype,
                           dilation=dilation)
        self.BatchNorm_1 = BatchNorm(features, momentum=_MOMENTUM)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.ConvBN_0 = ConvBN(cin, features, 1, stride, relu=False,
                                   dtype=dtype, bn_momentum=_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)
        out = self.BatchNorm_1(self.Conv_1(out))
        residual = self.ConvBN_0(x) if self.shortcut else x
        return torch.relu(out + residual.to(out.dtype)).to(self.dtype)


class ResBottleneck(nn.Module):
    """Bottleneck residual block with optional dilation."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = features * 4
        self.ConvBN_0 = ConvBN(cin, features, 1, 1, dtype=dtype,
                               bn_momentum=_MOMENTUM)
        self.Conv_0 = Conv(features, features, 3, stride, dtype=dtype,
                           dilation=dilation)
        self.BatchNorm_0 = BatchNorm(features, momentum=_MOMENTUM)
        self.ConvBN_1 = ConvBN(features, out_ch, 1, 1, relu=False,
                               dtype=dtype, bn_momentum=_MOMENTUM)
        self.shortcut = stride != 1 or cin != out_ch
        if self.shortcut:
            self.ConvBN_2 = ConvBN(cin, out_ch, 1, stride, relu=False,
                                   dtype=dtype, bn_momentum=_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBN_0(x)
        out = torch.relu(self.BatchNorm_0(self.Conv_0(out))).to(self.dtype)
        out = self.ConvBN_1(out)
        residual = self.ConvBN_2(x) if self.shortcut else x
        return torch.relu(out + residual.to(out.dtype)).to(self.dtype)


_ARCH = {
    # depth: (block, blocks per layer)
    18: (ResBlock, (2, 2, 2, 2)),
    34: (ResBlock, (3, 4, 6, 3)),
    50: (ResBottleneck, (3, 4, 6, 3)),
}
# (features, stride, dilation) per layer at output stride 8
_PLAN = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


class ResNetBackbone8s(nn.Module):
    """Dilated ResNet at output stride 8 (resnet.py:116-221): NCHW in,
    (x2s, x4s, x8s, xfc) feature maps at strides 2, 4, 8, 8 out."""

    def __init__(self, depth: int = 18, fc_dim: int = 256, in_ch: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        block, layout = _ARCH[depth]
        self.Conv_0 = Conv(in_ch, 64, 7, 2, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64, momentum=_MOMENTUM)
        cin, i = 64, 0
        self.layer_ends = []
        for (features, stride, dilation), n_blocks in zip(_PLAN, layout):
            for bi in range(n_blocks):
                self.add_module(f'{block.__name__}_{i}', block(
                    cin, features, stride=stride if bi == 0 else 1,
                    dilation=dilation, dtype=dtype))
                cin, i = features * block.expansion, i + 1
            self.layer_ends.append(i)
        self.n_blocks = i
        self.block_name = block.__name__
        self.out_channels = [64, 64 * block.expansion, 128 * block.expansion]
        self.ConvBN_0 = ConvBN(cin, fc_dim, 3, 1, dtype=dtype,
                               bn_momentum=_MOMENTUM)

    def forward(self, x: torch.Tensor):
        x = self.Conv_0(x.to(self.dtype))
        x2s = torch.relu(self.BatchNorm_0(x)).to(self.dtype)
        x = F.max_pool2d(x2s, 3, stride=2, padding=1)
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f'{self.block_name}_{i}')(x)
            if i + 1 in self.layer_ends:
                feats.append(x)
        return x2s, feats[0], feats[1], self.ConvBN_0(feats[3])


class ConvBNLeaky(nn.Module):
    """3x3 conv + BatchNorm + leaky ReLU (slope 0.1)."""

    def __init__(self, cin: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, features, 3, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)),
                            0.1).to(self.dtype)


def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisation: conv kernels LeCun normal (truncated
    at 2 std), biases 0, BatchNorm identity.  Draws on the generator's
    device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                lecun_normal_(p, generator)
            elif 'BatchNorm' in name and name.endswith('weight'):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith('running_var') else 0.0)


class ResNet8s(nn.Module):
    """ResNet-8s keypoint net (net.py Resnet18_8s / Resnet50_8s): input
    (B, H, W, C) -> (B, H, W, ver_dim) f32 maps."""

    def __init__(self, ver_dim: int = 32, depth: int = 18, fc_dim: int = 256,
                 s8_dim: int = 128, s4_dim: int = 64, s2_dim: int = 32,
                 raw_dim: int = 32, in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ResNetBackbone8s_0 = ResNetBackbone8s(depth, fc_dim, in_ch,
                                                   dtype)
        c2, c4, c8 = self.ResNetBackbone8s_0.out_channels
        self.ConvBNLeaky_0 = ConvBNLeaky(fc_dim + c8, s8_dim, dtype)
        self.ConvBNLeaky_1 = ConvBNLeaky(s8_dim + c4, s4_dim, dtype)
        self.ConvBNLeaky_2 = ConvBNLeaky(s4_dim + c2, s2_dim, dtype)
        self.ConvBNLeaky_3 = ConvBNLeaky(s2_dim + in_ch, raw_dim, dtype)
        self.Conv_0 = Conv(raw_dim, ver_dim, 1, bias=True, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> ResNet8s:
        _init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        x2s, x4s, x8s, xfc = self.ResNetBackbone8s_0(raw)
        fm = self.ConvBNLeaky_0(torch.cat([xfc, x8s], 1))
        fm = resize_bilinear(fm, x4s.shape[2:], align_corners=True)
        fm = self.ConvBNLeaky_1(torch.cat([fm, x4s], 1))
        fm = resize_bilinear(fm, x2s.shape[2:], align_corners=True)
        fm = self.ConvBNLeaky_2(torch.cat([fm, x2s], 1))
        fm = resize_bilinear(fm, raw.shape[2:], align_corners=True)
        fm = self.ConvBNLeaky_3(torch.cat([fm, raw], 1))
        return self.Conv_0(fm).to(torch.float32).permute(0, 2, 3, 1)


class ResNet8s2o(nn.Module):
    """Two-output PVNet head (net.py:157-223 ``Resnet50_8s_2o``):
    segmentation logits and a vertex field from one decoder.  Returns (seg
    (B, H, W, seg_dim), vertex (B, H, W, ver_dim)), ver_dim = 2 K,
    reshapeable to (B, H, W, K, 2) for ``ops/voting``."""

    def __init__(self, ver_dim: int = 18, seg_dim: int = 2, depth: int = 50,
                 fc_dim: int = 384, s8_dim: int = 256, s4_dim: int = 128,
                 s2_dim: int = 64, raw_dim: int = 64, in_ch: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.seg_dim = seg_dim
        self.ResNet8s_0 = ResNet8s(seg_dim + ver_dim, depth, fc_dim, s8_dim,
                                   s4_dim, s2_dim, raw_dim, in_ch, dtype)

    def init_weights(self, generator: torch.Generator) -> ResNet8s2o:
        _init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        out = self.ResNet8s_0(x)
        return out[..., :self.seg_dim], out[..., self.seg_dim:]


class ResNet8sDetector(nn.Module):
    """Single-channel objectness head over the dilated backbone
    (lib/networks/model_repository.py:302-330): ``tap='fc'`` convolves the
    fc feature, ``tap='8s'`` the layer-2 feature.  Input (B, H, W, C) ->
    (B, H/8, W/8, 1) logits."""

    def __init__(self, depth: int = 18, tap: str = 'fc', in_ch: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.tap = tap
        self.dtype = dtype
        self.ResNetBackbone8s_0 = ResNetBackbone8s(depth, 256, in_ch, dtype)
        cin = 256 if tap == 'fc' else self.ResNetBackbone8s_0.out_channels[2]
        self.Conv_0 = Conv(cin, 1, 3, bias=True, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> ResNet8sDetector:
        _init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        _, _, x8s, xfc = self.ResNetBackbone8s_0(raw)
        feat = xfc if self.tap == 'fc' else x8s
        return self.Conv_0(feat).to(torch.float32).permute(0, 2, 3, 1)


def pvnet_loss(seg_logits: torch.Tensor, vertex_pred: torch.Tensor,
               mask: torch.Tensor, vertex_target: torch.Tensor,
               vertex_weight: float = 1.0) -> torch.Tensor:
    """PVNet training loss: per-pixel segmentation cross-entropy plus the
    masked smooth-L1 of the vertex field (``ops/vertex.vertex_loss``)."""
    labels = mask.to(torch.int32)
    ls = torch.log_softmax(seg_logits, dim=-1)
    seg_ce = (-ls[..., 0] * (1 - labels) - ls[..., 1] * labels).mean()
    b, h, w, _ = vertex_pred.shape
    k = vertex_target.shape[-2]
    vl = vertex_loss(vertex_pred.reshape(b, h, w, k, 2), vertex_target,
                     mask)
    return seg_ce + vertex_weight * vl


def resnet18_8s(ver_dim: int = 32, **kw) -> ResNet8s:
    """net.py:7-79 defaults."""
    return ResNet8s(ver_dim=ver_dim, depth=18, fc_dim=256, s8_dim=128,
                    s4_dim=64, s2_dim=32, raw_dim=32, **kw)


def resnet50_8s(ver_dim: int = 32, **kw) -> ResNet8s:
    """net.py:81-155 defaults."""
    return ResNet8s(ver_dim=ver_dim, depth=50, fc_dim=384, s8_dim=256,
                    s4_dim=128, s2_dim=64, raw_dim=64, **kw)


def resnet34_8s(ver_dim: int = 32, **kw) -> ResNet8s:
    """net.py:225-299 defaults."""
    return ResNet8s(ver_dim=ver_dim, depth=34, fc_dim=256, s8_dim=128,
                    s4_dim=64, s2_dim=32, raw_dim=32, **kw)
