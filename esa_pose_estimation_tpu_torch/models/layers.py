"""Shared model building blocks (torch port of the JAX package's
``models/layers.py``; reference: seg_hrnet3.py:26-145).

Internally the network runs NCHW tensors; the serving model keeps them in
``torch.channels_last`` memory, so an NHWC view of any activation is free.
Parameters are f32 masters, as Flax keeps them: :class:`Conv` casts its
input, kernel and bias to the model dtype (bf16 for serving and training)
at use, as ``nn.Conv(dtype=...)`` does.  BatchNorm computes in f32, then
ReLU, then casts back to the model dtype, as the reference does.

Submodule attribute names follow the Flax auto-numbering of the JAX model
(``ConvBN_0``, ``BasicBlock_1``, ``CBAM_0``, ...), so a trained JAX
parameter tree maps leaf by leaf onto this module tree
(``utils/artifact.from_jax_variables``).

BatchNorm follows Flax's rule in both modes: running statistics in eval
mode; under ``model.train()`` the batch statistics, with the running ones
updated as ``m * running + (1 - m) * batch`` at a per-site momentum m (0.9
in the residual-block bodies, 0.99 everywhere else, as the JAX model sets
them after the reference).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import fused_cbam
from esa_pose_estimation_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    gather_from_model,
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


@functools.lru_cache(maxsize=None)
def _half_pixel_matrix(in_size: int, out_size: int,
                       device: torch.device) -> torch.Tensor:
    """(out, in) f32 tent weights of ``F.interpolate``'s half-pixel
    sampling, (o + 0.5) * in/out - 0.5 clamped to [0, in - 1]: its two
    taps per output, with the clamped border's weight on the edge.  Made
    once per shape and device (a network has a handful): a backward then
    launches its two products and no set-up."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device)
           + 0.5) * (in_size / out_size) - 0.5
    return _interp_matrix(torch.clamp(pos, 0.0, in_size - 1.0), in_size)


class _HalfPixelResize(torch.autograd.Function):
    """``F.interpolate(mode='bilinear', align_corners=False)`` forward, and
    as backward the transposed tent products, which add in a fixed order:
    the CUDA backward of ``F.interpolate`` adds with atomics, so two runs
    of one training step differ in the last bits."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=(oh, ow), mode='bilinear',
                             align_corners=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (h, w), (oh, ow) = ctx.in_hw, grad.shape[-2:]
        wy = _half_pixel_matrix(h, oh, grad.device)
        wx = _half_pixel_matrix(w, ow, grad.device)
        nhwc = grad.permute(0, 2, 3, 1).to(torch.float32)
        rows = torch.einsum('oh,nowc->nhwc', wy, nhwc)
        out = torch.einsum('pw,nhpc->nhwc', wx, rows)
        return out.to(grad.dtype).permute(0, 3, 1, 2), None, None


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW maps.

    ``align_corners=False`` is ``jax.image.resize`` (half-pixel centers).
    The network only upsamples here (by 2, 4 or 8), where its renormalized
    border taps equal ``F.interpolate``'s clamped ones.  Its backward is
    :class:`_HalfPixelResize`'s, deterministic on the card.
    ``align_corners=True`` (``nn.UpsamplingBilinear2d``) runs as two
    tent-weight products with the weights cast to the activation dtype, as
    the reference does, so bf16 rounds the weights the same way.
    """
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if not align_corners:
        return _HalfPixelResize.apply(x, oh, ow)
    dt = x.dtype if x.is_floating_point() else torch.float32
    wy = _align_corners_matrix(h, oh, x.device).to(dt)
    wx = _align_corners_matrix(w, ow, x.device).to(dt)
    nhwc = x.permute(0, 2, 3, 1)
    rows = torch.einsum('oh,nhwc->nowc', wy, nhwc)
    out = torch.einsum('pw,nowc->nopc', wx, rows)
    return out.permute(0, 3, 1, 2)


def _in_group() -> bool:
    """Whether this process has joined a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _global_moments(x: torch.Tensor, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel E[x] and E[x^2] of NCHW ``x`` over the batches of the
    ranks of ``group`` (None: every rank): one autograd all-reduce of the
    sums and the element count."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce
    c = x.shape[1]
    stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                       x.new_full((1,), float(x.numel() // c))])
    stats = all_reduce(stats, group=dist.group.WORLD if group is None
                       else group)
    return stats[:c] / stats[2 * c], stats[c:2 * c] / stats[2 * c]


class BatchNorm(nn.Module):
    """Flax's BatchNorm in f32 (eps 1e-5), op order
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    Eval mode normalizes with the running statistics.  Training mode takes
    the batch mean and ``var = mean(x^2) - mean(x)^2`` clipped at 0 over
    (N, H, W) (flax's ``use_fast_variance``), normalizes with them, and
    updates ``running = momentum * running + (1 - momentum) * batch`` with
    that biased variance.  ``nn.BatchNorm2d`` stores the unbiased variance
    and counts momentum the other way, so it is not used.

    Inside an initialised process group, of any size, training mode takes
    the statistics over the global batch, as JAX does under GSPMD: each
    rank's per-channel ``(sum x, sum x^2, count)`` are summed over the
    ranks with the autograd ``all_reduce``, so the gradient flows through
    the global statistics, and the rule above applies to them.  Every rank
    then holds the same running statistics, and a one-rank group runs the
    collectives that several ranks run.  Without a group the means are
    taken locally.  Under a mesh with a ``model`` axis the statistics are
    the data axis's: ``data_axis`` (set by ``parallel/mesh.shard_state``)
    names the group of ranks that hold other slices of the batch, and the
    sums run over it alone (over the whole group each data slice would
    count once per model rank).
    (``nn.SyncBatchNorm`` also keeps the unbiased variance.)
    """

    data_axis = None        # a parallel.tensor_parallel.Axis, or None

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            if _in_group():
                mean, mean_sq = _global_moments(
                    x, None if self.data_axis is None
                    else self.data_axis.group)
            else:
                mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(
                    dim=(0, 2, 3))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


class Conv(nn.Conv2d):
    """A conv with f32 parameters that computes in ``dtype``: input, kernel
    and bias are cast at use, as Flax's ``nn.Conv(dtype=...)`` casts them.
    Padding is ``dilation * (k//2)`` on both sides, the stride-2 convs
    included (Flax's ``padding=dilation`` of the dilated ResNet-8s convs).
    A serving model may store the parameters in ``dtype`` already
    (:func:`store_in_compute_dtype`); the cast is then a no-op.

    Split over the ``model`` axis of a process mesh
    (``parallel/mesh.shard_state``), ``model_axis`` holds this rank's
    place and the weight holds its rows of the output channels: the
    input's gradient is summed over the axis and the output slices are
    gathered (``parallel/tensor_parallel``); a bias stays whole and is
    added after the gather."""

    model_axis = None       # a parallel.tensor_parallel.Axis, or None

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype=torch.float32, dilation: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=dilation * (kernel // 2), dilation=dilation,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        axis = self.model_axis
        if axis is None:
            return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                            self.padding, self.dilation, self.groups)
        y = gather_from_model(F.conv2d(
            copy_to_model(x, axis).to(dt), self.weight.to(dt), None,
            self.stride, self.padding, self.dilation), axis)
        return y if bias is None else y + bias[:, None, None]


@torch.no_grad()
def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill a conv kernel (O, I, kh, kw) as Flax's default initialiser
    does: LeCun normal, truncated at 2 std, drawn on the generator's
    device."""
    fan_in = p[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(p.shape, device=generator.device)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    p.copy_(w)


def store_in_compute_dtype(model: nn.Module) -> nn.Module:
    """Cast every :class:`Conv`'s parameters to its compute dtype, in
    place: the serving form, which spends no cast per forward.  bf16(f32
    master) is the bf16 the forward would cast to, so the outputs are
    bit-equal to those of the f32 masters.  Not for training."""
    for m in model.modules():
        if isinstance(m, Conv):
            m.to(m.compute_dtype)
    return model


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm (f32) [+ ReLU], cast to the model dtype."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, dtype=torch.float32,
                 bn_momentum: float = 0.99):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.Conv_0 = Conv(cin, features, kernel, stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.relu:
            x = torch.relu(x)
        return x.to(self.dtype)


class SeparableConvBN(nn.Module):
    """HRFormer's downsampling step of a fusion: a depthwise 3x3 conv of
    stride 2 + BatchNorm, then a 1x1 conv + BatchNorm [+ ReLU], no conv
    bias (mmpose ``HRFomerModule._make_fuse_layers``), cast to the model
    dtype."""

    def __init__(self, cin: int, features: int, relu: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.Conv_0 = Conv(cin, cin, 3, 2, dtype=dtype, groups=cin)
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_1 = Conv(cin, features, 1, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x)).to(self.dtype)
        x = self.BatchNorm_1(self.Conv_1(x))
        if self.relu:
            x = torch.relu(x)
        return x.to(self.dtype)


class ChannelAttention(nn.Module):
    """CBAM channel gate: sigmoid(MLP(avgpool) + MLP(maxpool)), shared
    C -> C/16 -> C 1x1-conv MLP without bias (seg_hrnet3.py:32-47)."""

    def __init__(self, channels: int, ratio: int = 16, dtype=torch.float32):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.Conv_0 = Conv(channels, hidden, 1, dtype=dtype)
        self.Conv_1 = Conv(hidden, channels, 1, dtype=dtype)

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
        self.Conv_0 = Conv(2, 1, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.Conv_0(s))


# Dispatch of CBAM to the fused kernel (experimental/cbam_fuse.py): None
# follows takes_fused_cbam's rule; True and False force either path
# outside training, for tests and chip_smoke.py.
FUSED_CBAM: bool | None = None


def takes_fused_cbam(training: bool, device: torch.device, dtype: torch.dtype,
                     needs_grad: bool, channels: int) -> bool:
    """Whether a CBAM site runs as one call of the fused kernel: never in
    training (the kernel has no autograd); else as ``FUSED_CBAM`` forces
    it; else for a CUDA bf16 input that needs no gradient, with C a power
    of two in [8, 4096] (the kernel's shapes; the launch raises on any
    other fault).  Every other input runs the plain chain, CPU tensors
    included."""
    if training:
        return False
    if FUSED_CBAM is not None:
        return FUSED_CBAM
    return (device.type == 'cuda' and dtype == torch.bfloat16
            and not needs_grad and 8 <= channels <= 4096
            and channels & (channels - 1) == 0)


class CBAM(nn.Module):
    """Channel + spatial gate, optionally fused with the residual tail.

    ``forward(x)`` returns the gated map (the attended stem skip);
    ``forward(x, residual)`` also applies the block tail
    ``relu(gated + residual)`` (seg_hrnet3.py:95-97).  Where
    :func:`takes_fused_cbam` says so, the whole tail is one call of the
    fused kernel's wrapper (the kernel on CUDA, its plain version on CPU),
    which reads the convs' weights where they are stored.
    """

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ChannelAttention_0 = ChannelAttention(channels, dtype=dtype)
        self.SpatialAttention_0 = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        ca = self.ChannelAttention_0
        fc1, fc2 = ca.Conv_0.weight, ca.Conv_1.weight
        spw = self.SpatialAttention_0.Conv_0.weight
        needs_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, fc1, fc2, spw))
        if takes_fused_cbam(self.training, x.device, x.dtype, needs_grad,
                            x.shape[1]):
            # the stored weights, f32 masters or the bf16 serving form, as
            # the JAX model hands its f32 parameters to the kernel
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
        # the block body at the reference's torch-default momentum 0.1
        # (Flax 0.9); the downsample at BN_MOMENTUM 0.01 (Flax 0.99)
        self.ConvBN_0 = ConvBN(cin, features, 3, stride, dtype=dtype,
                               bn_momentum=0.9)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False,
                               dtype=dtype, bn_momentum=0.9)
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
        self.ConvBN_0 = ConvBN(cin, features, 1, 1, dtype=dtype,
                               bn_momentum=0.9)
        self.ConvBN_1 = ConvBN(features, features, 3, stride, dtype=dtype,
                               bn_momentum=0.9)
        self.ConvBN_2 = ConvBN(features, out_ch, 1, 1, relu=False,
                               dtype=dtype, bn_momentum=0.9)
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
