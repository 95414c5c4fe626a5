"""HRNet multi-resolution keypoint network (torch port of the JAX package's
``models/hrnet.py``; reference: models/seg_hrnet3.py:301-548).

Structure for a 128x128 crop: stem conv3x3 s1 (raw output kept for the
head skip) + BN + conv3x3 s2 -> stage 1 blocks -> stages 2-4 (transition
+ modules with cross-resolution fusion) -> head (upsample all branches,
concat, 3x3 + 1x1 convs, bilinear x2 with align_corners=True, concat the
CBAM-attended stem, 3x3 conv with bias -> K maps).

:class:`HRNet` takes ``(B, H, W, in_channels)`` and returns f32
``(B, H, W, K)`` channels-last heatmaps, the JAX model's layout; inside it
runs NCHW tensors in channels_last memory.  Module names follow the Flax
auto-numbering (see ``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from esa_pose_estimation_tpu_torch.experimental.merged_fuse import merged_fuse
from esa_pose_estimation_tpu_torch.models.layers import (
    BLOCKS,
    CBAM,
    BatchNorm,
    Conv,
    ConvBN,
    lecun_normal_,
    resize_bilinear,
)
from esa_pose_estimation_tpu_torch.utils.config import HRNetConfig, StageConfig


class BranchBlocks(nn.Module):
    """A sequence of residual blocks forming one branch of a stage."""

    def __init__(self, block: str, num_blocks: int, cin: int, features: int,
                 with_cbam: bool, dtype=torch.float32):
        super().__init__()
        blk = BLOCKS[block]
        self.names = []
        for i in range(num_blocks):
            name = f'{blk.__name__}_{i}'
            self.add_module(name, blk(cin, features, with_cbam=with_cbam,
                                      dtype=dtype))
            self.names.append(name)
            cin = features * blk.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


# Eval-time fuse-layer conv merging (experimental/merged_fuse.py).
# Module-level so tests and chip_smoke.py can force either path.  Default
# False, as in the JAX package.
MERGED_FUSE: bool = False


class FuseLayer(nn.Module):
    """Cross-resolution fusion (seg_hrnet3.py:219-292).  For output branch
    i and input branch j: j > i: 1x1 conv + BN then bilinear upsample;
    j == i: identity; j < i: (i-j) strided 3x3 convs (ReLU between, none
    on the last).  Outputs relu(sum_j path_ij(x_j)) per branch.

    With ``MERGED_FUSE`` set and the module not training, the same
    parameters run through the merged eval program (BN folded into the
    convs, same-source paths as one conv).
    """

    def __init__(self, num_branches: int, channels: tuple[int, ...],
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_branches = num_branches
        self.channels = tuple(channels)
        self.paths: list[list[list[str]]] = []
        n = 0

        def add(module):
            nonlocal n
            name = f'ConvBN_{n}'
            self.add_module(name, module)
            n += 1
            return name

        for i in range(num_branches):
            row = []
            for j in range(num_branches):
                if j == i:
                    row.append([])
                elif j > i:
                    row.append([add(ConvBN(channels[j], channels[i], 1, 1,
                                           relu=False, dtype=dtype))])
                else:
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = channels[i] if last else channels[j]
                        chain.append(add(ConvBN(channels[j], ch, 3, 2,
                                                relu=not last, dtype=dtype)))
                    row.append(chain)
            self.paths.append(row)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        if MERGED_FUSE and not self.training:
            return merged_fuse(self, xs, resize_bilinear)
        outs = []
        for i, row in enumerate(self.paths):
            y = None
            for j, chain in enumerate(row):
                path = xs[j]
                for name in chain:
                    path = getattr(self, name)(path)
                if j > i:
                    path = resize_bilinear(path, tuple(xs[i].shape[2:4]),
                                           align_corners=False)
                y = path if y is None else y + path
            outs.append(torch.relu(y).to(self.dtype))
        return outs


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch blocks then fusion."""

    def __init__(self, cfg: StageConfig, in_channels: tuple[int, ...],
                 with_cbam: bool, dtype=torch.float32):
        super().__init__()
        blk = BLOCKS[cfg.block]
        channels = tuple(c * blk.expansion for c in cfg.num_channels)
        self.num_branches = cfg.num_branches
        for i in range(cfg.num_branches):
            self.add_module(f'BranchBlocks_{i}', BranchBlocks(
                cfg.block, cfg.num_blocks[i], in_channels[i],
                cfg.num_channels[i], with_cbam, dtype=dtype))
        if cfg.num_branches > 1:
            self.FuseLayer_0 = FuseLayer(cfg.num_branches, channels,
                                         dtype=dtype)
        self.out_channels = channels

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        xs = [getattr(self, f'BranchBlocks_{i}')(x) for i, x in enumerate(xs)]
        if self.num_branches == 1:
            return xs
        return self.FuseLayer_0(xs)


class Transition(nn.Module):
    """Stage transition (seg_hrnet3.py:390-424): adapt the channel counts of
    existing branches, spawn new lower-resolution branches from the last."""

    def __init__(self, in_channels: tuple[int, ...],
                 out_channels: tuple[int, ...], dtype=torch.float32):
        super().__init__()
        n_pre = len(in_channels)
        self.paths: list[list[str]] = []
        n = 0
        for i, ch in enumerate(out_channels):
            chain = []
            if i < n_pre:
                if in_channels[i] != ch:
                    chain.append((in_channels[i], ch, 1))
            else:
                cin = in_channels[-1]
                for j in range(i + 1 - n_pre):
                    out_ch = ch if j == i - n_pre else in_channels[-1]
                    chain.append((cin, out_ch, 2))
                    cin = out_ch
            names = []
            for cin, cout, stride in chain:
                name = f'ConvBN_{n}'
                self.add_module(name, ConvBN(cin, cout, 3, stride,
                                             dtype=dtype))
                names.append(name)
                n += 1
            self.paths.append(names)
        self.n_pre = n_pre

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i, names in enumerate(self.paths):
            y = xs[i] if i < self.n_pre else xs[-1]
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return outs


class HRNet(nn.Module):
    """The full network: (B, H, W, in_channels) -> f32 (B, H, W, K)."""

    def __init__(self, cfg: HRNetConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg
        self.stem_conv1 = Conv(c.in_channels, c.stem_channels, 3,
                               dtype=dtype)
        self.stem_bn1 = BatchNorm(c.stem_channels)
        self.ConvBN_0 = ConvBN(c.stem_channels, c.stem_channels, 3, 2,
                               dtype=dtype)
        s1 = c.stage1
        self.BranchBlocks_0 = BranchBlocks(s1.block, s1.num_blocks[0],
                                           c.stem_channels,
                                           s1.num_channels[0], c.with_cbam,
                                           dtype=dtype)
        chans = (s1.num_channels[0] * BLOCKS[s1.block].expansion,)
        self.stage_names: list[tuple[str, list[str]]] = []
        n_mod = 0
        for t, stage in enumerate((c.stage2, c.stage3, c.stage4)):
            blk = BLOCKS[stage.block]
            out_channels = tuple(ch * blk.expansion
                                 for ch in stage.num_channels)
            self.add_module(f'Transition_{t}',
                            Transition(chans, out_channels, dtype=dtype))
            chans = out_channels
            mods = []
            for _ in range(stage.num_modules):
                name = f'HRModule_{n_mod}'
                self.add_module(name, HRModule(stage, chans, c.with_cbam,
                                               dtype=dtype))
                mods.append(name)
                n_mod += 1
            self.stage_names.append((f'Transition_{t}', mods))
        total = sum(chans)
        # the FLOP-dominant head conv is the one marked for the int8
        # serving path (layers.INT8_SERVING), as in the JAX model
        self.ConvBN_1 = ConvBN(total, total, c.first_head_kernel, 1,
                               dtype=dtype, int8_serving=True)
        self.ConvBN_2 = ConvBN(total, c.num_keypoints, c.final_conv_kernel,
                               1, dtype=dtype)
        if c.attended_stem_skip:
            self.CBAM_0 = CBAM(c.stem_channels, dtype=dtype)
            skip_ch = c.stem_channels
        else:
            skip_ch = c.in_channels
        self.output_conv = Conv(c.num_keypoints + skip_ch, c.num_keypoints,
                                3, bias=True, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> HRNet:
        """Draw the weights as the JAX model initialises them (Flax's
        defaults): conv kernels LeCun normal, conv biases 0, BatchNorm
        identity with zero mean and unit variance.  Draws on the
        generator's device."""
        for m in self.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        raw_in = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        # the raw conv1 output (pre-BN) feeds the head skip
        stem = self.stem_conv1(raw_in)
        x = torch.relu(self.stem_bn1(stem)).to(self.dtype)
        x = self.ConvBN_0(x)
        xs = [self.BranchBlocks_0(x)]
        for trans, mods in self.stage_names:
            xs = getattr(self, trans)(xs)
            for name in mods:
                xs = getattr(self, name)(xs)

        h0, w0 = xs[0].shape[2:4]
        ups = [xs[0]] + [resize_bilinear(b, (h0, w0), align_corners=False)
                         for b in xs[1:]]
        total = torch.cat(ups, 1)
        total = self.ConvBN_2(self.ConvBN_1(total))
        # back to the INPUT resolution
        total = resize_bilinear(total, tuple(raw_in.shape[2:4]),
                                align_corners=True)
        skip = self.CBAM_0(stem) if c.attended_stem_skip else raw_in
        skip = resize_bilinear(skip, tuple(total.shape[2:4]),
                               align_corners=True)
        out = self.output_conv(torch.cat([total, skip], 1))
        return out.to(torch.float32).permute(0, 2, 3, 1)
