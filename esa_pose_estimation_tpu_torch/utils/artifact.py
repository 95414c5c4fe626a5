"""Weights between the JAX package and the port: the npz inference
artifact, the Flax variable tree, and the port's own checkpoints.

Artifact format (the JAX package's ``utils/artifact.py``): a flat npz;
``meta`` holds a JSON dict; every other entry is ``p:<slash/path>`` (a param
leaf, bf16 stored as a uint16 bitcast) or ``s:<path>`` (a batch-stat leaf,
f32).  :func:`read_artifact` reads it and :func:`save_inference_artifact`
writes it, so an artifact exported from a port checkpoint (``python -m
esa_pose_estimation_tpu_torch.utils.artifact``) loads in the JAX package.

:func:`from_jax_variables` maps a Flax variable tree onto the port's
``state_dict`` and :func:`to_jax_variables` maps back.  The port's module
names follow the Flax auto-numbering, so the mapping is per leaf: conv
``kernel`` (HWIO) <-> ``weight`` (OIHW), BatchNorm ``scale`` <-> ``weight``,
``bias`` <-> ``bias``, batch-stat ``mean``/``var`` <->
``running_mean``/``running_var``.  :func:`from_jax_adam` carries an optax
Adam state (the ``mu``/``nu`` trees, leaf by leaf the same way, and
``count``) onto ``torch.optim.Adam``, so a JAX train state resumes in the
port; ``to_jax_variables(model, optimizer)`` gives it back.
"""

from __future__ import annotations

import json
import os

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


def _to_torch_leaves(tree, leaf_map: dict[str, str], what: str
                     ) -> dict[str, torch.Tensor]:
    """A Flax tree (numpy leaves) -> {dotted torch name: f32 CPU tensor}."""
    out: dict[str, torch.Tensor] = {}
    for path, v in _flatten(tree).items():
        *mods, leaf = path.split('/')
        if leaf not in leaf_map:
            raise KeyError(f'unmapped {what} leaf {path!r}')
        a = np.array(v, np.float32)          # a writable copy
        if leaf == 'kernel':
            if a.ndim != 4:
                raise ValueError(f'{path}: expected an HWIO conv kernel, '
                                 f'got shape {a.shape}')
            a = a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        key = '.'.join(mods + [leaf_map[leaf]])
        if key in out:
            raise KeyError(f'two leaves map to {key!r}')
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """Flax ``{'params': ..., 'batch_stats': ...}`` (numpy leaves) -> the
    port's ``state_dict`` (f32 tensors on the CPU)."""
    sd = _to_torch_leaves(variables.get('params', {}), _PARAM_LEAF, 'params')
    for k, v in _to_torch_leaves(variables.get('batch_stats', {}),
                                 _STAT_LEAF, 'batch_stats').items():
        if k in sd:
            raise KeyError(f'two leaves map to {k!r}')
        sd[k] = v
    return sd


def from_jax_adam(mu, nu, count: int, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer) -> dict:
    """An optax ``scale_by_adam`` state (``mu``/``nu`` trees shaped like the
    params, numpy leaves; ``count`` updates) -> a state_dict for
    ``optimizer``, a ``torch.optim.Adam`` over ``model.parameters()``.
    optax's mu/nu are torch's exp_avg/exp_avg_sq and its count the step."""
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    m = _to_torch_leaves(mu, _PARAM_LEAF, 'mu')
    v = _to_torch_leaves(nu, _PARAM_LEAF, 'nu')
    if set(m) != set(index) or set(v) != set(index):
        raise KeyError(f'Adam moments do not cover the model: missing '
                       f'{sorted(set(index) - set(m))[:4]}, unexpected '
                       f'{sorted(set(m) - set(index))[:4]}')
    state = {index[k]: {'step': torch.tensor(float(count)),
                        'exp_avg': m[k], 'exp_avg_sq': v[k]} for k in index}
    return {'state': state,
            'param_groups': optimizer.state_dict()['param_groups']}


def _jax_leaf(key: str, t: torch.Tensor) -> tuple[str, np.ndarray]:
    """A torch state_dict entry -> (slash path, numpy leaf) in the Flax
    tree: OIHW weights become HWIO kernels, 1-d weights (BatchNorm's
    only) scales."""
    *mods, leaf = key.split('.')
    a = t.detach().to(device='cpu', dtype=torch.float32).numpy()
    if leaf == 'weight':
        if a.ndim == 4:
            leaf, a = 'kernel', a.transpose(2, 3, 1, 0)
        else:
            leaf = 'scale'
    elif leaf in ('running_mean', 'running_var'):
        leaf = leaf[len('running_'):]
    return '/'.join(mods + [leaf]), np.ascontiguousarray(a)


def to_jax_variables(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer | None = None) -> dict:
    """The inverse of :func:`from_jax_variables` (and, with ``optimizer``,
    of :func:`from_jax_adam`): ``{'params', 'batch_stats'}`` trees of f32
    numpy leaves, plus ``'adam': {'mu', 'nu', 'count'}``."""
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        path, a = _jax_leaf(key, t)
        (stats if key.endswith(('running_mean', 'running_var'))
         else params)[path] = a
    out = {'params': _unflatten(params), 'batch_stats': _unflatten(stats)}
    if optimizer is not None:
        names = [n for n, _ in model.named_parameters()]
        sd = optimizer.state_dict()['state']
        mu, nu, count = {}, {}, 0
        for i, name in enumerate(names):
            st = sd[i]
            mu.update([_jax_leaf(name, st['exp_avg'])])
            nu.update([_jax_leaf(name, st['exp_avg_sq'])])
            count = int(st['step'])
        out['adam'] = {'mu': _unflatten(mu), 'nu': _unflatten(nu),
                       'count': count}
    return out


def save_inference_artifact(path: str, model: torch.nn.Module,
                            meta: dict | None = None) -> None:
    """Write ``model``'s params (as bf16) and batch stats (f32) with
    ``meta`` in the JAX package's artifact format."""
    variables = to_jax_variables(model)
    payload = {'meta': np.frombuffer(json.dumps(meta or {}).encode(),
                                     dtype=np.uint8)}
    for k, v in _flatten(variables['params']).items():
        b16 = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16)
        payload[_PARAM + k] = b16.numpy().view(np.uint16)
    for k, v in _flatten(variables['batch_stats']).items():
        payload[_STAT + k] = np.asarray(v, np.float32)
    np.savez_compressed(path, **payload)


def _config_for(meta: dict, cfg):
    if cfg is not None:
        return cfg
    model = meta.get('model', 'hrnet_esa')
    configs = {'hrnet_esa': cfg_mod.hrnet_esa, 'hrnet_tiny': cfg_mod.hrnet_tiny}
    if model not in configs:
        raise ValueError(f'artifact model {model!r} has no port config')
    return configs[model]()


def target_device(device, who: str) -> torch.device:
    """``device`` (default ``cuda``) as a torch.device; asking for cuda
    without a card raises (no quiet CPU run)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{who}: cuda requested but no CUDA device is '
                           "available (pass device='cpu')")
    return device


def load_hrnet_artifact(path: str, cfg=None, dtype=torch.bfloat16,
                        device=None):
    """Artifact -> HRNet in eval mode, in the serving form: conv parameters
    stored in ``dtype`` (``models.layers.store_in_compute_dtype``), whose
    outputs equal those of the f32 masters bit for bit.

    ``cfg`` defaults to the config the artifact's meta names.  The model
    goes to ``cuda`` unless ``device`` says otherwise; asking for ``cuda``
    without one raises.  Every artifact leaf must map onto a model tensor
    and every model tensor must be covered (strict load).
    """
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.models.layers import (
        store_in_compute_dtype,
    )

    device = target_device(device, 'load_hrnet_artifact')
    variables, meta = read_artifact(path)
    model = HRNet(_config_for(meta, cfg), dtype=dtype)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    return store_in_compute_dtype(model).eval()


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


def load_cli_checkpoint(workdir: str, name: str, tiny: bool, device):
    """The commands' checkpoint route: the port checkpoint
    ``<workdir>/net_esa/<name>`` (``train/checkpoint.py``) -> the bf16
    HRNet in its serving form on ``device``, and the checkpoint's epoch.  A
    missing name raises ``FileNotFoundError`` listing the names there."""
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.models.layers import (
        store_in_compute_dtype,
    )
    from esa_pose_estimation_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from esa_pose_estimation_tpu_torch.train.state import TrainState

    device = target_device(device, 'load_cli_checkpoint')
    cfg = cfg_mod.hrnet_tiny() if tiny else cfg_mod.hrnet_esa()
    model = HRNet(cfg, dtype=torch.bfloat16).to(
        device=device, memory_format=torch.channels_last)
    _, next_epoch = CheckpointManager(
        os.path.join(workdir, 'net_esa')).restore_required(
        name, TrainState(model))
    return store_in_compute_dtype(model).eval(), next_epoch - 1


def load_detector(variables, width: int = 32, stride: int = 16,
                  device=None):
    """Flax detector variables ``{'params': ..., 'batch_stats': ...}``
    (numpy leaves) -> a float32 :class:`~models.detector.TinyDetector` in
    eval mode (strict load).  It goes to ``cuda`` unless ``device`` says
    otherwise; asking for ``cuda`` without one raises."""
    from esa_pose_estimation_tpu_torch.models.detector import TinyDetector

    device = target_device(device, 'load_detector')
    model = TinyDetector(width=width, stride=stride)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def main(argv=None) -> str:
    """Export an artifact from a port checkpoint:

    python -m esa_pose_estimation_tpu_torch.utils.artifact --workdir runs/esa \
        --out artifacts/esa_best.npz [--checkpoint best_rotate] [--tiny]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.split('\n\n')[0])
    ap.add_argument('--workdir', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--checkpoint', default='best_rotate')
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help="where to load the checkpoint: 'cuda' (default) "
                         "or 'cpu'")
    args = ap.parse_args(argv)
    model, epoch = load_cli_checkpoint(args.workdir, args.checkpoint,
                                       args.tiny, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_inference_artifact(
        args.out, model,
        meta={'checkpoint': args.checkpoint, 'epoch': epoch,
              'model': 'hrnet_tiny' if args.tiny else 'hrnet_esa',
              'crop_size': args.crop_size})
    print(f'wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, '
          f'epoch {epoch})')
    return args.out


if __name__ == '__main__':
    main()
