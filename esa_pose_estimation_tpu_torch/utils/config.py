"""Typed configuration: HRNet topology, training and loss settings, YAML
loading and CLI overrides (a copy of the JAX package's
``utils/config.py``).

The port keeps its own copy rather than importing the JAX package: the two
packages share no module.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class StageConfig:
    """One HRNet stage (reference: config/default.py:45-75)."""
    num_modules: int
    num_branches: int
    num_blocks: tuple[int, ...]
    num_channels: tuple[int, ...]
    block: str = 'BASIC'            # 'BASIC' | 'BOTTLENECK'
    fuse_method: str = 'SUM'

    def block_kw(self, branch: int) -> dict:
        """Keyword arguments of branch ``branch``'s blocks besides their
        widths: none for HRNet's residual blocks."""
        return {}


@dataclass(frozen=True)
class HRFormerStageConfig(StageConfig):
    """A stage of HRFormer blocks: each branch's attention heads, the
    square window and the FFN's expansion besides.  The HRNet configs keep
    :class:`StageConfig`, field for field the JAX package's."""
    block: str = 'HRFORMER'
    num_heads: tuple[int, ...] = ()
    window_size: int = 7
    mlp_ratio: int = 4

    def block_kw(self, branch: int) -> dict:
        return dict(num_heads=self.num_heads[branch],
                    window_size=self.window_size, mlp_ratio=self.mlp_ratio)


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


def hrnet_rgb32() -> HRNetConfig:
    """seg_hrnet.py variant: RGB input, 32 outputs, no attention
    (reference: models/seg_hrnet.py:265,324,335)."""
    return HRNetConfig(in_channels=3, num_keypoints=32, with_cbam=False,
                       attended_stem_skip=False, first_head_kernel=1)


def hrnet_gray11() -> HRNetConfig:
    """seg_hrnet2.py variant: grayscale input, 11 outputs, no attention."""
    return HRNetConfig(in_channels=1, num_keypoints=11, with_cbam=False,
                       attended_stem_skip=False, first_head_kernel=1)


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


@dataclass(frozen=True)
class ViTPoseConfig:
    """ViTPose (Xu et al., NeurIPS 2022, arXiv:2204.12484): a plain vision
    transformer over ``patch_size`` patches and the classic head of
    ``len(head_channels)`` stride-2 deconvolutions, heatmaps at
    1/2**len(head_channels) of the input.  Defaults: ViTPose-H's widths
    (``ViTPose_huge_coco_256x192.py``), at the port's crop and keypoints
    (:func:`vitpose_h_speed`)."""
    num_keypoints: int = 30
    img_size: int = 512
    patch_size: int = 16
    patch_padding: int = 2
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: int = 4
    ln_eps: float = 1e-6
    head_channels: tuple[int, ...] = (256, 256)

    @property
    def grid(self) -> int:
        """Patches along a side."""
        return ((self.img_size + 2 * self.patch_padding - self.patch_size)
                // self.patch_size + 1)


def vitpose_h_speed() -> ViTPoseConfig:
    """ViTPose-H at every published width, on SPEED's grey 512x512 crops
    with 30 keypoints: 32x32 = 1,024 tokens, 128x128 heatmaps (stride 4),
    the shape the peak decode reads for ``hrnet_esa``."""
    return ViTPoseConfig()


def vitpose_tiny() -> ViTPoseConfig:
    """Small ViTPose for tests: 64x64 crops, 4x4 tokens of width 64, two
    blocks of four heads of 16, 16x16 heatmaps of 8 keypoints."""
    return ViTPoseConfig(num_keypoints=8, img_size=64, embed_dim=64,
                         depth=2, num_heads=4, head_channels=(32, 32))


@dataclass(frozen=True)
class HRFormerConfig:
    """HRFormer (Yuan et al., "HRFormer: High-Resolution Transformer for
    Dense Prediction", NeurIPS 2021, arXiv:2110.09408; mmpose's
    ``hrformer_base_coco_384x288.py``): a two-conv stride-4 stem, stage 1
    of Bottlenecks, then stages 2-4 of HRNet's multi-resolution modules
    whose branches are HRFormer blocks (window self-attention, depthwise-
    conv FFN), fused with depthwise-separable downsampling, and a 1x1 conv
    to the heatmaps on the highest-resolution branch, at 1/4 of the input.
    Defaults: HRFormer-B's widths at the port's crop and keypoints
    (:func:`hrformer_b_speed`)."""
    num_keypoints: int = 30
    img_size: int = 512
    stem_channels: int = 64
    stage1: StageConfig = StageConfig(1, 1, (2,), (64,), 'BOTTLENECK')
    stage2: HRFormerStageConfig = HRFormerStageConfig(
        1, 2, (2, 2), (78, 156), num_heads=(2, 4))
    stage3: HRFormerStageConfig = HRFormerStageConfig(
        4, 3, (2, 2, 2), (78, 156, 312), num_heads=(2, 4, 8))
    stage4: HRFormerStageConfig = HRFormerStageConfig(
        2, 4, (2, 2, 2, 2), (78, 156, 312, 624), num_heads=(2, 4, 8, 16))

    @property
    def stages(self) -> tuple[StageConfig, ...]:
        return (self.stage1, self.stage2, self.stage3, self.stage4)


def hrformer_b_speed() -> HRFormerConfig:
    """HRFormer-B at every published width (channels 78, 156, 312, 624;
    heads 2, 4, 8, 16 of 39; 7x7 windows; MLP x4; 1, 4, 2 modules of 2
    blocks a branch: 44 blocks) on SPEED's grey 512x512 crops with 30
    keypoints: branches of 128, 64, 32 and 16 pixels a side, 128x128
    heatmaps (stride 4), the shape the peak decode reads."""
    return HRFormerConfig()


def hrformer_tiny() -> HRFormerConfig:
    """Small HRFormer for tests: 64x64 crops, heads of 39 kept, one module
    of one block a branch, branches of 16, 8, 4 and 2 pixels a side (none
    a multiple of 7, so every window pads), 16x16 heatmaps of 8
    keypoints."""
    return HRFormerConfig(
        num_keypoints=8, img_size=64, stem_channels=16,
        stage1=StageConfig(1, 1, (1,), (16,), 'BOTTLENECK'),
        stage2=HRFormerStageConfig(1, 2, (1, 1), (39, 78), num_heads=(1, 2),
                                   mlp_ratio=2),
        stage3=HRFormerStageConfig(1, 3, (1, 1, 1), (39, 78, 117),
                                   num_heads=(1, 2, 3), mlp_ratio=2),
        stage4=HRFormerStageConfig(1, 4, (1, 1, 1, 1), (39, 78, 117, 156),
                                   num_heads=(1, 2, 3, 4), mlp_ratio=2))


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference: main.py:257-302)."""
    batch_size: int = 32
    crop_size: int = 128
    gauss_sigma: float = 2.0
    lr: float = 1e-4
    lr_boundaries: tuple[int, ...] = (80, 100, 170)   # epochs
    lr_values: tuple[float, ...] = (1e-4, 1e-5, 1e-6, 1e-7)
    num_epochs: int = 100
    loss_weight_w: float = 10.0
    eval_every: int = 5
    eval_after: int = 80
    seed: int = 0
    compute_dtype: str = 'bfloat16'


@dataclass(frozen=True)
class LossConfig:
    """HeatmapWing parameters (reference: loss.py:61-129)."""
    alpha: float = 2.1
    omega: float = 14.0
    epsilon: float = 2.0
    theta: float = 0.5
    weight_w: float = 10.0


def _from_dict(cls, data: dict[str, Any]):
    # Resolve annotations via get_type_hints: under PEP 563 (this module's
    # `from __future__ import annotations`) f.type is a STRING, so a bare
    # dataclasses.is_dataclass(f.type) is always False and nested configs
    # would silently stay raw dicts, failing only later and far from the
    # YAML-loading site.
    import typing
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_yaml(path: str, cls=HRNetConfig):
    """Load a config dataclass from a YAML file (update_config parity,
    reference: config/default.py:152-158)."""
    import yaml
    with open(path) as f:
        return _from_dict(cls, yaml.safe_load(f) or {})


def _coerce_override(old, val: str, key: str):
    """Parse a CLI override string to the type of the current value,
    with errors that name the offending override (a bare eval() raised
    NameError on 'false' and TypeError on tuple(80), both far from any
    hint of which flag was malformed)."""
    import ast
    if isinstance(old, str):
        return val
    if isinstance(old, bool):          # before int: bool subclasses int
        low = val.strip().lower()
        if low in ('true', '1', 'yes', 'on'):
            return True
        if low in ('false', '0', 'no', 'off'):
            return False
        raise ValueError(f'override {key}={val!r}: expected a boolean')
    try:
        parsed = ast.literal_eval(val)
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f'override {key}={val!r}: not a Python literal '
            f'({type(old).__name__} expected)') from e
    if isinstance(old, tuple):
        # accept a bare scalar for a 1-element tuple field
        if not isinstance(parsed, (list, tuple)):
            parsed = (parsed,)
        return tuple(parsed)
    return type(old)(parsed)


def apply_overrides(cfg, overrides: list[str]):
    """'key=value' CLI overrides (merge_from_list parity)."""
    data = dataclasses.asdict(cfg)
    for ov in overrides:
        key, sep, val = ov.partition('=')
        if not sep:
            raise ValueError(f'override {ov!r}: expected key=value')
        node = data
        parts = key.split('.')
        try:
            for p in parts[:-1]:
                node = node[p]
            old = node[parts[-1]]
        except (KeyError, TypeError):
            raise ValueError(
                f'override {ov!r}: no config field {key!r} on '
                f'{type(cfg).__name__}') from None
        node[parts[-1]] = _coerce_override(old, val, key)
    return _from_dict(type(cfg), data)
