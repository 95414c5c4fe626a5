"""Inference artifacts: read the JAX package's ``.npz`` weights into the port.

Artifact format (written by the JAX package's ``utils/artifact.py``): a flat
npz; ``meta`` holds a JSON dict; every other entry is ``p:<slash/path>``
(a param leaf, bf16 stored as a uint16 bitcast) or ``s:<path>`` (a
batch-stat leaf, f32).

:func:`from_jax_variables` maps a Flax variable tree onto the port's
``state_dict``.  The port's module names follow the Flax auto-numbering, so
the mapping is per leaf: conv ``kernel`` (HWIO) -> ``weight`` (OIHW),
BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``, batch-stat
``mean``/``var`` -> ``running_mean``/``running_var``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.utils import config as cfg_mod

_PARAM, _STAT = 'p:', 's:'


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree, prefix: str = '') -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else str(k)
        if hasattr(v, 'items'):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def read_meta(path: str) -> dict:
    """The artifact's ``meta`` dict alone (no weights are read)."""
    with np.load(path) as z:
        return json.loads(bytes(z['meta']).decode()) if 'meta' in z else {}


def read_artifact(path: str) -> tuple[dict, dict]:
    """Returns ``(variables, meta)``: ``variables`` is
    ``{'params': tree, 'batch_stats': tree}`` of f32 numpy arrays, as the
    JAX package's ``load_inference_artifact`` gives them."""
    meta = read_meta(path)
    with np.load(path) as z:
        params, stats = {}, {}
        for k in z.files:
            if k.startswith(_PARAM):
                u16 = z[k].view(np.uint16)
                params[k[len(_PARAM):]] = (u16.astype(np.uint32) << 16
                                           ).view(np.float32)
            elif k.startswith(_STAT):
                stats[k[len(_STAT):]] = np.asarray(z[k], np.float32)
    return {'params': _unflatten(params),
            'batch_stats': _unflatten(stats)}, meta


_PARAM_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAF = {'mean': 'running_mean', 'var': 'running_var'}


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """Flax ``{'params': ..., 'batch_stats': ...}`` (numpy leaves) -> the
    port's ``state_dict`` (f32 tensors on the CPU)."""
    sd: dict[str, torch.Tensor] = {}
    for coll, leaf_map in (('params', _PARAM_LEAF),
                           ('batch_stats', _STAT_LEAF)):
        for path, v in _flatten(variables.get(coll, {})).items():
            *mods, leaf = path.split('/')
            if leaf not in leaf_map:
                raise KeyError(f'unmapped {coll} leaf {path!r}')
            a = np.array(v, np.float32)          # a writable copy
            if leaf == 'kernel':
                if a.ndim != 4:
                    raise ValueError(f'{path}: expected an HWIO conv kernel, '
                                     f'got shape {a.shape}')
                a = a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
            key = '.'.join(mods + [leaf_map[leaf]])
            if key in sd:
                raise KeyError(f'two leaves map to {key!r}')
            sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _config_for(meta: dict, cfg):
    if cfg is not None:
        return cfg
    model = meta.get('model', 'hrnet_esa')
    configs = {'hrnet_esa': cfg_mod.hrnet_esa, 'hrnet_tiny': cfg_mod.hrnet_tiny}
    if model not in configs:
        raise ValueError(f'artifact model {model!r} has no port config')
    return configs[model]()


def _target_device(device, who: str) -> torch.device:
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{who}: cuda requested but no CUDA device is '
                           "available (pass device='cpu')")
    return device


def load_hrnet_artifact(path: str, cfg=None, dtype=torch.bfloat16,
                        device=None):
    """Artifact -> HRNet in eval mode.

    ``cfg`` defaults to the config the artifact's meta names.  The model
    goes to ``cuda`` unless ``device`` says otherwise; asking for ``cuda``
    without one raises.  Every artifact leaf must map onto a model tensor
    and every model tensor must be covered (strict load).
    """
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet

    device = _target_device(device, 'load_hrnet_artifact')
    variables, meta = read_artifact(path)
    model = HRNet(_config_for(meta, cfg), dtype=dtype)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def load_cli_artifact(path: str, tiny: bool, crop_size: int, device):
    """The command-line tools' weight load: the artifact's recorded model
    and crop size are checked against the flags (a mismatch exits with a
    message, where it would otherwise fail deep inside the strict load),
    then the bf16 HRNet goes to ``device``.  Returns ``(model, meta)``."""
    meta = read_meta(path)
    want = 'hrnet_tiny' if tiny else 'hrnet_esa'
    if meta.get('model') and meta['model'] != want:
        raise SystemExit(
            f"artifact {path} was exported from {meta['model']!r} but the "
            f"flags select {want!r} ({'drop' if tiny else 'pass'} --tiny)")
    if meta.get('crop_size') and meta['crop_size'] != crop_size:
        raise SystemExit(f"artifact {path} expects --crop-size "
                         f"{meta['crop_size']}, got {crop_size}")
    cfg = cfg_mod.hrnet_tiny() if tiny else cfg_mod.hrnet_esa()
    return load_hrnet_artifact(path, cfg=cfg, dtype=torch.bfloat16,
                               device=device), meta


def load_detector(variables, width: int = 32, stride: int = 16,
                  device=None):
    """Flax detector variables ``{'params': ..., 'batch_stats': ...}``
    (numpy leaves) -> a float32 :class:`~models.detector.TinyDetector` in
    eval mode (strict load).  It goes to ``cuda`` unless ``device`` says
    otherwise; asking for ``cuda`` without one raises."""
    from esa_pose_estimation_tpu_torch.models.detector import TinyDetector

    device = _target_device(device, 'load_detector')
    model = TinyDetector(width=width, stride=stride)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()
