"""Package rules of the port: no JAX in it, its keypoint model equals the
JAX one, and its CPU entry points never touch CUDA."""

import ast
from pathlib import Path

import numpy as np
import torch

from esa_pose_estimation_tpu.data import synthetic as jsyn

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'esa_pose_estimation_tpu')


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    # match by module path: esa_pose_estimation_tpu_torch is allowed
    top = mod.split('.')[0]
    return top in FORBIDDEN


def test_port_imports_no_jax():
    files = sorted((ROOT / 'esa_pose_estimation_tpu_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imported_modules(f)
                                            if _forbidden(m))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_forbidden_matcher():
    assert _forbidden('esa_pose_estimation_tpu.ops.peak')
    assert _forbidden('jax.numpy')
    assert not _forbidden('esa_pose_estimation_tpu_torch.ops.peak')
    assert not _forbidden('jaxtyping_free')


def test_spacecraft_points_equal_jax():
    from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
    np.testing.assert_array_equal(tsyn.spacecraft_points().numpy(),
                                  np.asarray(jsyn.spacecraft_points()))


def test_cpu_entry_points_never_touch_cuda(monkeypatch):
    """infer_poses with every serving lever on, and the eval CLI, on CPU
    tensors: no CUDA call and no kernel build."""
    from esa_pose_estimation_tpu_torch import _build
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.cli import eval_synthetic
    from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
    from esa_pose_estimation_tpu_torch.models import hrnet, layers
    from esa_pose_estimation_tpu_torch.ops import peak
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )

    def refuse(*a, **k):
        raise AssertionError('CUDA touched on a CPU path')

    monkeypatch.setattr(torch.cuda, '_lazy_init', refuse)
    monkeypatch.setattr(torch.cuda, 'current_stream', refuse)
    monkeypatch.setattr(_build, 'load', refuse)
    monkeypatch.setattr(_build, 'build_all', refuse)
    monkeypatch.setattr(layers, 'FUSED_CBAM', True)
    monkeypatch.setattr(layers, 'INT8_SERVING', True)
    monkeypatch.setattr(hrnet, 'MERGED_FUSE', True)
    monkeypatch.setattr(peak, 'NHWC_DECODE', True)
    model = load_hrnet_artifact('artifacts/esa_syn_r5.npz',
                                dtype=torch.float32, device='cpu')
    gen = torch.Generator().manual_seed(0)
    s = tsyn.make_sample(gen, tsyn.spacecraft_points(), 1, height=300,
                         width=480)
    K = tsyn.scaled_intrinsics(300, 480)
    out = pipeline.infer_poses(model, s.image, s.bbox,
                               tsyn.spacecraft_points(), gen, K=K,
                               n_hypotheses=8, lm_iters=2)
    assert out.quat.device.type == 'cpu'
    assert torch.isfinite(out.quat).all()
    rec = eval_synthetic.main(['--artifact', 'artifacts/esa_syn_r5.npz',
                               '--device', 'cpu', '--frames', '2',
                               '--batch-size', '2', '--int8'])
    assert rec['frames'] + rec['nonfinite_frames'] == 2
