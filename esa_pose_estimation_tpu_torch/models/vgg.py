"""VGG conv feature extractors, the PoseCNN-era baselines (torch port of
the JAX package's ``models/vgg.py``).

The reference's VGG family (lib/networks/vgg.py:86-197 factories,
lib/networks/vgg16_convs.py:21-60 ``VGG16Convs``, a two-scale feature
extractor), with the BatchNorm variants of ``vgg*_bn``.  NCHW in and
out; the module names follow the Flax auto-numbering (``Conv_i``,
``BatchNorm_i``, ``VGGFeatures_0``), so ``utils/artifact.
from_jax_variables`` carries the JAX weights across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.models.layers import BatchNorm, Conv
from esa_pose_estimation_tpu_torch.models.resnet8s import _init_weights

# layer widths; 'M' is a 2x2 max-pool
CFGS: dict[str, tuple] = {
    'vgg11': (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'vgg13': (64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M',
              512, 512, 'M'),
    'vgg16': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512, 'M'),
    'vgg19': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
              512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'),
}


class VGGFeatures(nn.Module):
    """The VGG conv trunk.  Returns one map per stage: the activation
    before each pool (``conv*_N``; for vgg16 stage 3 is the stride-8
    conv4_3 map), then the map after the last pool."""

    def __init__(self, cfg: str = 'vgg16', batch_norm: bool = False,
                 in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.plan = []
        cin, ci = in_ch, 0
        for item in CFGS[cfg]:
            if item == 'M':
                self.plan.append('M')
                continue
            self.add_module(f'Conv_{ci}', Conv(cin, item, 3, bias=True,
                                               dtype=dtype))
            if batch_norm:
                self.add_module(f'BatchNorm_{ci}', BatchNorm(item,
                                                             momentum=0.9))
            self.plan.append(ci)
            cin, ci = item, ci + 1
        self.batch_norm = batch_norm

    def init_weights(self, generator: torch.Generator) -> VGGFeatures:
        _init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.to(self.dtype)
        stages = []
        for item in self.plan:
            if item == 'M':
                stages.append(x)
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f'Conv_{item}')(x)
            if self.batch_norm:
                x = getattr(self, f'BatchNorm_{item}')(x)
            x = F.relu(x).to(self.dtype)
        stages.append(x)
        return stages


class VGG16Convs(nn.Module):
    """Two-scale extractor (vgg16_convs.py:21-60): (conv4_3 at stride 8,
    conv5_3 at stride 16)."""

    def __init__(self, in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        self.VGGFeatures_0 = VGGFeatures('vgg16', in_ch=in_ch, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> VGG16Convs:
        _init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        stages = self.VGGFeatures_0(x)
        return stages[3], stages[4]
