"""Reference torch checkpoints into the port's models, and back (port of
the JAX package's ``utils/torch_import.py``).

The reference trains its ResNet-8s backbones from torchvision ImageNet
weights (resnet.py:223-280 ``load_state_dict(model_zoo...)``) and saves
and loads its HRNet as a torch ``state_dict`` (main.py:176-204).  This
module maps such a checkpoint onto the port's module names, so that

* a reference-trained ``seg_hrnet3``-family checkpoint serves through
  ``pipeline.infer_poses`` (:func:`import_reference_hrnet`), and a port
  model exports back to the reference's names
  (:func:`export_reference_hrnet`);
* a reference ``Resnet{18,34,50}_8s`` checkpoint loads whole into
  ``models.resnet8s.ResNet8s`` or, with ``scope=('ResNet8s_0',)``,
  ``ResNet8s2o`` (:func:`import_reference_resnet8s`);
* the dilated backbone starts from a torchvision ``resnet18/34/50``
  state_dict (:func:`import_torchvision_resnet`).

A plan is a list of ``(kind, torch_prefix, path)`` operations, mirrored
from the JAX module; ``path`` is the module path in the port, the Flax
path joined by dots (``('ConvBN_0', 'Conv_0')`` is ``ConvBN_0.Conv_0``).
Both sides keep conv weights OIHW, so a conv is copied as is, except:

* a biased conv feeding BatchNorm (the reference head, seg_hrnet3.py:
  360-376): the bias is folded into the running mean
  (``mean' = mean - bias``), since the port's ``ConvBN`` has no conv bias;
  an export writes that bias as zeros;
* grey input: where the port's conv takes one input channel and the
  checkpoint's three (ImageNet weights), the kernel is summed over the
  input channels (the response to a grey image replicated to RGB).
"""

from __future__ import annotations

from typing import Any, Iterable

import torch

from esa_pose_estimation_tpu_torch.utils.config import HRNetConfig, StageConfig

Path = tuple[str, ...]
Op = tuple[str, Any, Path]


def load_torch_checkpoint(path: str, allow_pickle: bool = False
                          ) -> dict[str, torch.Tensor]:
    """A ``.pth`` file -> a flat state_dict of CPU tensors.

    Takes a bare state_dict or the reference's ``{'net': state_dict,
    'optim': ..., 'epoch': ...}`` wrapper (main.py:176-182), and strips the
    ``module.`` prefixes of DataParallel (main.py:254).  Loads with
    ``weights_only=True`` unless ``allow_pickle``: both formats are plain
    tensors and dicts, and a full unpickle runs code from the file.
    """
    try:
        obj = torch.load(path, map_location='cpu',
                         weights_only=not allow_pickle)
    except Exception as e:
        if allow_pickle:
            raise
        raise RuntimeError(
            f'{path!r} does not load as a plain weights checkpoint; if '
            f'you trust its origin, retry with allow_pickle=True') from e
    if isinstance(obj, dict) and 'net' in obj and hasattr(obj['net'],
                                                          'items'):
        obj = obj['net']
    if hasattr(obj, 'state_dict'):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        out[k] = torch.as_tensor(v).detach().cpu()
    return out


# ---------------------------------------------------------------------------
# Plans.  kind: 'conv' (weight), 'convb' (weight and bias), 'bn', 'bnfold'
# (a BatchNorm whose conv had a bias: torch_prefix is (bn, conv)).
# ---------------------------------------------------------------------------

class _Plan:
    def __init__(self) -> None:
        self.ops: list[Op] = []

    def conv(self, t: str, f: Path) -> None:
        self.ops.append(('conv', t, f))

    def convb(self, t: str, f: Path) -> None:
        self.ops.append(('convb', t, f))

    def bn(self, t: str, f: Path) -> None:
        self.ops.append(('bn', t, f))

    def convbn(self, tconv: str, tbn: str, f: Path,
               conv_bias: bool = False) -> None:
        """A ConvBN block: conv at f.Conv_0, BatchNorm at f.BatchNorm_0."""
        self.conv(tconv, f + ('Conv_0',))
        if conv_bias:
            self.ops.append(('bnfold', (tbn, tconv), f + ('BatchNorm_0',)))
        else:
            self.bn(tbn, f + ('BatchNorm_0',))

    def cbam(self, t: str, f: Path) -> None:
        """The reference CBAM's ``ca``/``sa`` (seg_hrnet3.py:32-61)."""
        p = t + '.' if t else ''
        self.conv(f'{p}ca.fc.0', f + ('ChannelAttention_0', 'Conv_0'))
        self.conv(f'{p}ca.fc.2', f + ('ChannelAttention_0', 'Conv_1'))
        self.conv(f'{p}sa.conv1', f + ('SpatialAttention_0', 'Conv_0'))


def _hrnet_block(plan: _Plan, t: str, f: Path, block: str, inplanes: int,
                 planes: int, stride: int, with_cbam: bool) -> int:
    """One reference BasicBlock/Bottleneck (seg_hrnet3.py:63-145).
    Returns its output channels."""
    out_ch = planes * (4 if block == 'BOTTLENECK' else 1)
    plan.convbn(f'{t}.conv1', f'{t}.bn1', f + ('ConvBN_0',))
    plan.convbn(f'{t}.conv2', f'{t}.bn2', f + ('ConvBN_1',))
    if block == 'BOTTLENECK':
        plan.convbn(f'{t}.conv3', f'{t}.bn3', f + ('ConvBN_2',))
        ds_name = 'ConvBN_3'
    else:
        ds_name = 'ConvBN_2'
    if with_cbam:
        plan.cbam(t, f + ('CBAM_0',))
    if stride != 1 or inplanes != out_ch:
        plan.convbn(f'{t}.downsample.0', f'{t}.downsample.1',
                    f + (ds_name,))
    return out_ch


def _hrnet_branch(plan: _Plan, t: str, f: Path, block: str, n_blocks: int,
                  inplanes: int, planes: int, with_cbam: bool) -> int:
    """A block sequence (_make_layer / _make_one_branch,
    seg_hrnet3.py:426-442) -> BranchBlocks."""
    blk_name = 'Bottleneck' if block == 'BOTTLENECK' else 'BasicBlock'
    ch = inplanes
    for i in range(n_blocks):
        ch = _hrnet_block(plan, f'{t}.{i}', f + (f'{blk_name}_{i}',),
                          block, ch, planes, 1, with_cbam)
    return ch


def _hrnet_transition(plan: _Plan, t: str, f: Path, pre: list[int],
                      cur: list[int]) -> None:
    """_make_transition_layer (seg_hrnet3.py:392-424) -> Transition
    (ConvBN_k in creation order)."""
    k = 0
    n_pre = len(pre)
    for i, ch in enumerate(cur):
        if i < n_pre:
            if pre[i] != ch:
                plan.convbn(f'{t}.{i}.0', f'{t}.{i}.1', f + (f'ConvBN_{k}',))
                k += 1
        else:
            for j in range(i + 1 - n_pre):
                plan.convbn(f'{t}.{i}.{j}.0', f'{t}.{i}.{j}.1',
                            f + (f'ConvBN_{k}',))
                k += 1


def _hrnet_module(plan: _Plan, t: str, f: Path, stage: StageConfig,
                  cur: list[int], with_cbam: bool) -> None:
    """HighResolutionModule (seg_hrnet3.py:147-292) -> HRModule."""
    for b in range(stage.num_branches):
        _hrnet_branch(plan, f'{t}.branches.{b}', f + (f'BranchBlocks_{b}',),
                      stage.block, stage.num_blocks[b], cur[b],
                      stage.num_channels[b], with_cbam)
    if stage.num_branches == 1:
        return
    k = 0
    fuse = f + ('FuseLayer_0',)
    for i in range(stage.num_branches):
        for j in range(stage.num_branches):
            if j > i:
                plan.convbn(f'{t}.fuse_layers.{i}.{j}.0',
                            f'{t}.fuse_layers.{i}.{j}.1',
                            fuse + (f'ConvBN_{k}',))
                k += 1
            elif j < i:
                for s in range(i - j):
                    plan.convbn(f'{t}.fuse_layers.{i}.{j}.{s}.0',
                                f'{t}.fuse_layers.{i}.{j}.{s}.1',
                                fuse + (f'ConvBN_{k}',))
                    k += 1


def hrnet_plan(cfg: HRNetConfig) -> list[Op]:
    """The reference HRNet state_dict <-> port HRNet mapping (the
    reference's attribute layout, seg_hrnet3.py:300-470)."""
    plan = _Plan()
    plan.conv('conv1', ('stem_conv1',))
    plan.bn('bn1', ('stem_bn1',))
    plan.convbn('conv2', 'bn2', ('ConvBN_0',))

    s1 = cfg.stage1
    exp1 = 4 if s1.block == 'BOTTLENECK' else 1
    _hrnet_branch(plan, 'layer1', ('BranchBlocks_0',), s1.block,
                  s1.num_blocks[0], cfg.stem_channels, s1.num_channels[0],
                  cfg.with_cbam)
    pre = [s1.num_channels[0] * exp1]
    hr_idx = 0
    for si, stage in enumerate((cfg.stage2, cfg.stage3, cfg.stage4),
                               start=2):
        exp = 4 if stage.block == 'BOTTLENECK' else 1
        cur = [c * exp for c in stage.num_channels]
        _hrnet_transition(plan, f'transition{si - 1}',
                          (f'Transition_{si - 2}',), pre, cur)
        for m in range(stage.num_modules):
            _hrnet_module(plan, f'stage{si}.{m}', (f'HRModule_{hr_idx}',),
                          stage, cur, cfg.with_cbam)
            hr_idx += 1
        pre = cur
    # the head (seg_hrnet3.py:357-386): biased convs feeding BatchNorm
    plan.convbn('last_layer.0', 'last_layer.1', ('ConvBN_1',),
                conv_bias=True)
    plan.convbn('last_layer.3', 'last_layer.4', ('ConvBN_2',),
                conv_bias=True)
    if cfg.attended_stem_skip:
        plan.cbam('', ('CBAM_0',))
    plan.convb('output_layer.0', ('output_conv',))
    return plan.ops


def _prefix_ops(ops: Iterable[Op], prefix: str) -> list[Op]:
    """Prepend a torch attribute prefix (``resnet18_8s.``) to every torch
    key of a plan."""
    out = []
    for kind, t, f in ops:
        t = ((prefix + t[0], prefix + t[1]) if kind == 'bnfold'
             else prefix + t)
        out.append((kind, t, f))
    return out


def resnet8s_net_plan(depth: int) -> list[Op]:
    """The reference ``Resnet{18,34,50}_8s`` (net.py:7-155) <-> port
    ``ResNet8s``: the dilated backbone under ``resnet{depth}_8s.``, its
    replaced ``fc`` conv head (net.py:22-26), the ``conv8s/conv4s/conv2s/
    convraw`` decoder (net.py:30-59) and the last biased 1x1 conv."""
    backbone = f'resnet{depth}_8s'
    scope: Path = ('ResNetBackbone8s_0',)
    plan = _Plan()
    plan.ops += [(k, t, scope + f) for k, t, f in
                 _prefix_ops(resnet_plan(depth), backbone + '.')]
    plan.convbn(f'{backbone}.fc.0', f'{backbone}.fc.1',
                scope + ('ConvBN_0',))
    for i, name in enumerate(('conv8s', 'conv4s', 'conv2s', 'convraw')):
        plan.convbn(f'{name}.0', f'{name}.1', (f'ConvBNLeaky_{i}',))
    plan.convb('convraw.3', ('Conv_0',))
    return plan.ops


def resnet_plan(depth: int) -> list[Op]:
    """torchvision resnet{18,34,50} -> port ``ResNetBackbone8s`` (the
    dilated layers reuse the stock kernels; dilation changes no shape)."""
    layouts = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
    bottleneck = depth == 50
    plan = _Plan()
    plan.conv('conv1', ('Conv_0',))
    plan.bn('bn1', ('BatchNorm_0',))
    blk_name = 'ResBottleneck' if bottleneck else 'ResBlock'
    stages = [(64, 1), (128, 2), (256, 1), (512, 1)]   # (features, stride)
    inplanes = 64
    gi = 0
    for li, ((planes, stride), n_blocks) in enumerate(zip(stages,
                                                          layouts[depth])):
        for bi in range(n_blocks):
            t = f'layer{li + 1}.{bi}'
            f: Path = (f'{blk_name}_{gi}',)
            st = stride if bi == 0 else 1
            out_ch = planes * (4 if bottleneck else 1)
            if bottleneck:
                plan.convbn(f'{t}.conv1', f'{t}.bn1', f + ('ConvBN_0',))
                plan.conv(f'{t}.conv2', f + ('Conv_0',))
                plan.bn(f'{t}.bn2', f + ('BatchNorm_0',))
                plan.convbn(f'{t}.conv3', f'{t}.bn3', f + ('ConvBN_1',))
                ds = 'ConvBN_2'
            else:
                plan.conv(f'{t}.conv1', f + ('Conv_0',))
                plan.bn(f'{t}.bn1', f + ('BatchNorm_0',))
                plan.conv(f'{t}.conv2', f + ('Conv_1',))
                plan.bn(f'{t}.bn2', f + ('BatchNorm_1',))
                ds = 'ConvBN_0'
            if st != 1 or inplanes != out_ch:
                plan.convbn(f'{t}.downsample.0', f'{t}.downsample.1',
                            f + (ds,))
            inplanes = out_ch
            gi += 1
    return plan.ops


# ---------------------------------------------------------------------------
# Applying a plan
# ---------------------------------------------------------------------------

def _conv_weight(w: torch.Tensor, want_in: int) -> torch.Tensor:
    if w.shape[1] != want_in:
        if want_in != 1:
            raise ValueError(f'conv in-channels {w.shape[1]} != expected '
                             f'{want_in}')
        # RGB -> grey stem, summed in channel order
        acc = w[:, :1]
        for c in range(1, w.shape[1]):
            acc = acc + w[:, c:c + 1]
        w = acc
    return w


def apply_plan(target: dict[str, torch.Tensor],
               state_dict: dict[str, Any], ops: Iterable[Op],
               scope: Path = ()) -> tuple[dict[str, torch.Tensor], set[str]]:
    """A copy of the port state_dict ``target`` with the plan applied, and
    the set of torch keys consumed.  A torch key the plan needs and the
    checkpoint lacks raises ``KeyError``; a port name the plan writes that
    ``target`` lacks raises ``KeyError``; a shape mismatch ``ValueError``.
    Values take the dtype and device of ``target``'s tensors."""
    out = dict(target)
    used: set[str] = set()

    def sd(key: str) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(f'torch checkpoint missing key: {key}')
        used.add(key)
        return torch.as_tensor(state_dict[key]).detach().cpu()

    def put(name: str, value: torch.Tensor) -> None:
        if name not in out:
            raise KeyError(f'no parameter at {name}')
        old = out[name]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f'{name}: shape {tuple(value.shape)} != '
                             f'expected {tuple(old.shape)}')
        out[name] = value.to(dtype=old.dtype, device=old.device)

    for kind, t, f in ops:
        p = '.'.join(scope + f)
        if kind in ('conv', 'convb'):
            if f'{p}.weight' not in out:
                raise KeyError(f'no parameter at {p}.weight')
            put(f'{p}.weight', _conv_weight(sd(f'{t}.weight'),
                                            out[f'{p}.weight'].shape[1]))
            if kind == 'convb':
                put(f'{p}.bias', sd(f'{t}.bias'))
        elif kind in ('bn', 'bnfold'):
            if kind == 'bnfold':
                tbn, tconv = t
                fold = sd(f'{tconv}.bias')
            else:
                tbn, fold = t, None
            mean = sd(f'{tbn}.running_mean')
            put(f'{p}.weight', sd(f'{tbn}.weight'))
            put(f'{p}.bias', sd(f'{tbn}.bias'))
            put(f'{p}.running_mean', mean if fold is None else mean - fold)
            put(f'{p}.running_var', sd(f'{tbn}.running_var'))
        else:
            raise ValueError(kind)
    return out, used


def export_plan(source: dict[str, torch.Tensor], ops: Iterable[Op],
                scope: Path = ()) -> dict[str, torch.Tensor]:
    """The inverse of :func:`apply_plan`: a state_dict in the torch naming
    from the port state_dict ``source`` (f32 CPU tensors; folded conv
    biases are written as zeros)."""
    def get(name: str) -> torch.Tensor:
        return source[name].detach().to(device='cpu', dtype=torch.float32)

    sd: dict[str, torch.Tensor] = {}
    for kind, t, f in ops:
        p = '.'.join(scope + f)
        if kind in ('conv', 'convb'):
            sd[f'{t}.weight'] = get(f'{p}.weight')
            if kind == 'convb':
                sd[f'{t}.bias'] = get(f'{p}.bias')
            continue
        if kind == 'bnfold':
            tbn, tconv = t
            sd[f'{tconv}.bias'] = torch.zeros_like(get(f'{p}.bias'))
        else:
            tbn = t
        sd[f'{tbn}.weight'] = get(f'{p}.weight')
        sd[f'{tbn}.bias'] = get(f'{p}.bias')
        sd[f'{tbn}.running_mean'] = get(f'{p}.running_mean')
        sd[f'{tbn}.running_var'] = get(f'{p}.running_var')
    return sd


def _check_consumed(state_dict: dict, used: set[str]) -> None:
    """Every torch key but ``num_batches_tracked`` must have been read."""
    left = {k for k in state_dict
            if k not in used and not k.endswith('num_batches_tracked')}
    if left:
        raise ValueError(f'unconsumed torch keys: {sorted(left)[:8]}'
                         f'{" ..." if len(left) > 8 else ""}')


def _load(model: torch.nn.Module, state_dict: dict, ops: list[Op],
          scope: Path, strict: bool) -> torch.nn.Module:
    new, used = apply_plan(model.state_dict(), state_dict, ops, scope)
    if strict:
        _check_consumed(state_dict, used)
    model.load_state_dict(new)
    return model


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def import_reference_hrnet(model: torch.nn.Module, state_dict: dict,
                           cfg: HRNetConfig | None = None,
                           strict: bool = True) -> torch.nn.Module:
    """Load a reference ``seg_hrnet3``-family state_dict into the port's
    ``HRNet`` ``model`` (in place; returned).  ``cfg`` defaults to the
    model's.  ``strict`` also requires every torch key to be consumed
    (``num_batches_tracked`` aside)."""
    return _load(model, state_dict, hrnet_plan(cfg or model.cfg), (),
                 strict)


def import_reference_resnet8s(model: torch.nn.Module, state_dict: dict,
                              depth: int = 18, strict: bool = True,
                              scope: Path = ()) -> torch.nn.Module:
    """Load a whole reference ``Resnet{18,34,50}_8s`` state_dict (net.py:
    7-155, the LINEMOD heatmap-mode net), backbone and decoder, into a
    port ``ResNet8s``.  The PVNet seg + vertex net
    (model_repository.py:7-80) has the same layout with ``convraw.3``
    emitting ``seg_dim + ver_dim`` channels: load it into ``ResNet8s2o``
    with ``scope=('ResNet8s_0',)``, the 2o wrapper's trunk."""
    return _load(model, state_dict, resnet8s_net_plan(depth), scope, strict)


def import_torchvision_resnet(model: torch.nn.Module, state_dict: dict,
                              depth: int,
                              scope: Path = ('ResNetBackbone8s_0',)
                              ) -> torch.nn.Module:
    """Seed the dilated ResNet-8s backbone from torchvision ImageNet
    weights (resnet.py:223-280).  ``fc.*`` and the decoder are left as they
    are, as the reference's partial load leaves them."""
    return _load(model, state_dict, resnet_plan(depth), scope, False)


def export_reference_hrnet(model: torch.nn.Module,
                           cfg: HRNetConfig | None = None
                           ) -> dict[str, torch.Tensor]:
    """The port ``HRNet``'s weights under the reference's state_dict names
    (the complement of :func:`import_reference_hrnet`)."""
    return export_plan(model.state_dict(), hrnet_plan(cfg or model.cfg))
