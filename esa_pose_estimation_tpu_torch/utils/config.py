"""HRNet topology configuration (a copy of the JAX package's dataclasses).

The port keeps its own copy rather than importing the JAX package: the two
packages share no module.  YAML loading and CLI overrides are not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StageConfig:
    """One HRNet stage (reference: config/default.py:45-75)."""
    num_modules: int
    num_branches: int
    num_blocks: tuple[int, ...]
    num_channels: tuple[int, ...]
    block: str = 'BASIC'            # 'BASIC' | 'BOTTLENECK'
    fuse_method: str = 'SUM'


@dataclass(frozen=True)
class HRNetConfig:
    """HRNet topology + head layout.

    Defaults reproduce the reference ESA model ``seg_hrnet3``: grayscale
    stem (conv s1 + conv s2), CBAM attention in every block, 30-keypoint
    head with attended-stem skip connection.
    """
    in_channels: int = 1
    num_keypoints: int = 30
    stem_channels: int = 64
    final_conv_kernel: int = 1
    with_cbam: bool = True
    attended_stem_skip: bool = True     # seg_hrnet3 head; False = raw-input skip
    first_head_kernel: int = 3          # seg_hrnet3 uses 3, seg_hrnet uses 1
    stage1: StageConfig = StageConfig(1, 1, (2,), (32,), 'BASIC')
    stage2: StageConfig = StageConfig(1, 2, (2, 2), (32, 64), 'BASIC')
    stage3: StageConfig = StageConfig(1, 3, (2, 2, 2), (32, 64, 128), 'BASIC')
    stage4: StageConfig = StageConfig(1, 4, (4, 4, 4, 4), (32, 64, 128, 256), 'BASIC')

    @property
    def stages(self) -> tuple[StageConfig, ...]:
        return (self.stage1, self.stage2, self.stage3, self.stage4)


def hrnet_esa() -> HRNetConfig:
    """The flagship SPEED model (parity with seg_hrnet3.get_seg_model)."""
    return HRNetConfig()


def hrnet_tiny() -> HRNetConfig:
    """Small topology for tests."""
    return HRNetConfig(
        num_keypoints=6,
        stem_channels=8,
        stage1=StageConfig(1, 1, (1,), (8,)),
        stage2=StageConfig(1, 2, (1, 1), (8, 16)),
        stage3=StageConfig(1, 3, (1, 1, 1), (8, 16, 32)),
        stage4=StageConfig(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
    )
