"""Package rules of the port: no JAX in it, its keypoint model equals the
JAX one, and its CPU entry points never touch CUDA."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.data import synthetic as jsyn


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'esa_pose_estimation_tpu', 'scripts')


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
    names = {str(f.relative_to(ROOT / 'esa_pose_estimation_tpu_torch'))
             for f in files[:-1]}
    assert {'train/loss.py', 'train/state.py', 'train/checkpoint.py',
            'obs/logger.py', 'obs/tbevents.py', 'cli/train.py',
            'data/augment.py', 'data/pipeline.py', 'ops/heatmap.py',
            'cli/train_detector.py', 'data/shards.py',
            'data/native_loader.py', 'parallel/distributed.py',
            'parallel/mesh.py', 'cli/train_linemod.py', 'ops/voting.py',
            'ops/vertex.py', 'ops/geometry.py', 'models/resnet8s.py',
            'data/linemod.py', 'utils/render.py', 'eval/projector.py',
            'data/speed_gen.py', 'cli/inspect_db.py', 'obs/visual.py',
            'cli/dress_rehearsal.py', 'utils/torch_import.py',
            'obs/profiling.py', 'utils/device_probe.py',
            'utils/render_driver.py', 'data/db_builder.py', 'models/vgg.py',
            'ops/pose_nms.py', 'ops/transforms.py', 'utils/graphs.py',
            'pipeline.py', 'cli/mfu_experiments.py',
            'parallel/tensor_parallel.py'} <= names
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imported_modules(f)
                                            if _forbidden(m))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_forbidden_matcher():
    assert _forbidden('esa_pose_estimation_tpu.ops.peak')
    assert _forbidden('jax.numpy')
    assert _forbidden('scripts.dress_rehearsal')
    assert not _forbidden('esa_pose_estimation_tpu_torch.ops.peak')
    assert not _forbidden('jaxtyping_free')


def test_spacecraft_points_equal_jax():
    from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
    np.testing.assert_array_equal(tsyn.spacecraft_points().numpy(),
                                  np.asarray(jsyn.spacecraft_points()))


def _write_split(root: Path, frames, boxes) -> str:
    """The frames as PNGs and a pickle of unlabelled records."""
    import pickle

    from PIL import Image
    recs = []
    for i, (f, b) in enumerate(zip(frames, boxes)):
        name = f'img{i:06d}.png'
        Image.fromarray(f.numpy().astype(np.uint8)).save(root / name)
        recs.append({'rgb_pth': name, 'bbox': b.numpy(),
                     'sift3d': np.asarray(jsyn.spacecraft_points()),
                     'K': np.eye(3),
                     'qua': np.array([1.0, 0, 0, 0]),
                     'RT': np.concatenate([np.eye(3), [[0.1], [0], [10]]], 1)})
    with open(root / 'split.pkl', 'wb') as fh:
        pickle.dump(recs, fh)
    return str(root / 'split.pkl')


def test_cpu_entry_points_never_touch_cuda(monkeypatch, tmp_path):
    """infer_poses with every serving lever on, detect_and_infer with a
    seeded detector, the eval, evaluate and submit commands, detector
    training and the two-stage eval on its output, and keypoint training
    from an SPD1 shard with and without the host crop, on CPU tensors: no
    CUDA call and no kernel build."""
    from esa_pose_estimation_tpu_torch import _build
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.cli import (
        eval_synthetic,
        evaluate,
        submit,
        train,
        train_detector,
    )
    from esa_pose_estimation_tpu_torch.data import shards
    from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
    from esa_pose_estimation_tpu_torch.models import hrnet, layers
    from esa_pose_estimation_tpu_torch.models.detector import TinyDetector
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
    # the int8 lever costs seconds per forward on the CPU, and the paths
    # below add no int8 code
    monkeypatch.setattr(layers, 'INT8_SERVING', False)
    det = TinyDetector(width=8).init_weights(
        torch.Generator().manual_seed(0)).eval()
    s2 = tsyn.make_sample(gen, tsyn.spacecraft_points(), 2, height=300,
                          width=480)
    out = pipeline.detect_and_infer(det, model, s2.image,
                                    tsyn.spacecraft_points(), gen, K=K,
                                    n_hypotheses=8, lm_iters=2)
    assert out.quat.shape == (2, 4) and out.quat.device.type == 'cpu'
    pkl = _write_split(tmp_path, s2.image, s2.bbox)
    common = ['--artifact', 'artifacts/esa_syn_r5.npz', '--device', 'cpu',
              '--test-pkl', pkl, '--image-root', str(tmp_path),
              '--workdir', str(tmp_path), '--batch-size', '2']
    res = evaluate.main(common)
    assert 0 <= res['nonfinite'] <= 2 and 'speed' in res
    path = submit.main(common + ['--suffix', 'cpu'])
    assert len(open(path).read().strip().split('\n')) == 2
    det_wd = str(tmp_path / 'det')
    train_detector.main(['--workdir', det_wd, '--device', 'cpu', '--epochs',
                         '1', '--steps-per-epoch', '2', '--batch-size', '2',
                         '--height', '96', '--width', '160', '--downscale',
                         '2', '--width-ch', '8', '--eval-batches', '1',
                         '--augment'])
    rec = eval_synthetic.main(['--artifact', 'artifacts/esa_syn_r5.npz',
                               '--device', 'cpu', '--frames', '2',
                               '--batch-size', '2', '--n-hypotheses', '8',
                               '--detector-workdir', det_wd])
    assert rec['frames'] + rec['nonfinite_frames'] == 2
    shard = str(tmp_path / 'train.spd')
    shards.write_synthetic_shard(shard, 8, height=240, width=384, n_kp=6,
                                 batch=4, device='cpu')
    for crop in ([], ['--host-crop']):
        res = train.main(['--workdir', str(tmp_path / f'shard{len(crop)}'),
                          '--tiny', '--epochs', '1', '--batch-size', '4',
                          '--crop-size', '32', '--train-shard', shard,
                          '--eval-every', '1', '--device', 'cpu'] + crop)
        assert 'speed' in res


def test_cpu_mesh_never_touches_cuda(monkeypatch):
    """A mesh of CPU devices: make_mesh, shard_batch, replicate, the
    sharded pipeline and the sharded eval step, gathered: no CUDA call and
    no kernel build."""
    from esa_pose_estimation_tpu_torch import _build, pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.parallel import mesh as tmesh
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config

    def refuse(*a, **k):
        raise AssertionError('CUDA touched on a CPU path')

    monkeypatch.setattr(torch.cuda, '_lazy_init', refuse)
    monkeypatch.setattr(torch.cuda, 'current_stream', refuse)
    monkeypatch.setattr(torch.cuda, 'current_device', refuse)
    monkeypatch.setattr(_build, 'load', refuse)
    monkeypatch.setattr(_build, 'build_all', refuse)
    mesh = tmesh.make_mesh(devices=[torch.device('cpu')] * 2)
    model = HRNet(config.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()
    frames = torch.rand((4, 96, 96), generator=torch.Generator().manual_seed(
        1)) * 255
    boxes = torch.tensor([[8.0, 8.0, 80.0, 80.0]]).repeat(4, 1)
    out = pipeline.make_sharded_pipeline(
        model, tsyn.spacecraft_points(n=6), mesh, crop_size=32,
        n_hypotheses=4, lm_iters=1)(frames, boxes,
                                    torch.Generator().manual_seed(2))
    got = out.gather()
    assert got.quat.shape == (4, 4) and got.quat.device.type == 'cpu'
    batch = {'image': torch.randn(4, 32, 32, 1),
             'heatmaps': torch.rand(4, 32, 32, 6),
             'weights': torch.rand(4, 32, 32, 6)}
    heatmaps, losses = tstate.make_sharded_eval_step(mesh)(
        tmesh.replicate(model, mesh), batch)
    assert heatmaps.gather().shape == (4, 32, 32, 6)
    assert len(losses) == 2 and torch.isfinite(losses[0])


def test_cpu_training_never_touches_cuda(monkeypatch, tmp_path):
    """A tiny training run with both augmentations and an eval, through
    the synthetic route's scan, then eval_synthetic --perturb and the
    artifact export on its checkpoint, on the CPU: no CUDA call, no CUDA
    graph and no kernel build."""
    from esa_pose_estimation_tpu_torch import _build
    from esa_pose_estimation_tpu_torch.cli import eval_synthetic, train
    from esa_pose_estimation_tpu_torch.train import state as state_mod
    from esa_pose_estimation_tpu_torch.utils import artifact

    def refuse(*a, **k):
        raise AssertionError('CUDA touched on a CPU path')

    monkeypatch.setattr(torch.cuda, '_lazy_init', refuse)
    monkeypatch.setattr(torch.cuda, 'current_stream', refuse)
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', refuse)
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', refuse)
    monkeypatch.setattr(_build, 'load', refuse)
    monkeypatch.setattr(_build, 'build_all', refuse)
    scans = []
    real_scan = state_mod.make_scan_step

    def scan_spy(*args, **kwargs):
        scans.append(args[2])
        return real_scan(*args, **kwargs)
    monkeypatch.setattr(state_mod, 'make_scan_step', scan_spy)
    wd = str(tmp_path / 'run')
    train.main(['--workdir', wd, '--tiny', '--epochs', '1', '--batch-size',
                '4', '--crop-size', '32', '--synthetic-size', '8',
                '--eval-every', '1', '--augment-geom', '--augment-photo',
                '--device', 'cpu'])
    assert scans == [2]                 # the synthetic route's scan
    rec = eval_synthetic.main(['--workdir', wd, '--checkpoint', 'last',
                               '--tiny', '--crop-size', '32', '--frames',
                               '2', '--batch-size', '2', '--n-hypotheses',
                               '8', '--perturb', '--device', 'cpu'])
    assert rec['frames'] + rec['nonfinite_frames'] == 2
    out = str(tmp_path / 'tiny.npz')
    artifact.main(['--workdir', wd, '--checkpoint', 'last', '--tiny',
                   '--out', out, '--crop-size', '32', '--device', 'cpu'])
    assert artifact.read_meta(out)['model'] == 'hrnet_tiny'


def test_cpu_linemod_training_never_touches_cuda(monkeypatch, tmp_path):
    """cli.train_linemod in both modes, one epoch of one step with its eval
    (K1's plain version in heatmap mode, voting and uncertainty PnP in
    pvnet mode), on the CPU: no CUDA call and no kernel build."""
    from esa_pose_estimation_tpu_torch import _build
    from esa_pose_estimation_tpu_torch.cli import train_linemod

    def refuse(*a, **k):
        raise AssertionError('CUDA touched on a CPU path')

    monkeypatch.setattr(torch.cuda, '_lazy_init', refuse)
    monkeypatch.setattr(torch.cuda, 'current_stream', refuse)
    monkeypatch.setattr(_build, 'load', refuse)
    monkeypatch.setattr(_build, 'build_all', refuse)
    for mode in ('heatmap', 'pvnet'):
        res = train_linemod.main([
            '--workdir', str(tmp_path / mode), '--mode', mode, '--epochs',
            '1', '--steps-per-epoch', '1', '--batch-size', '2',
            '--crop-size', '32', '--num-keypoints', '4', '--device', 'cpu'])
        assert set(res) == {'projection_2d', 'add', 'cm_degree_5'}


def test_commands_ask_for_the_card_by_default(monkeypatch, tmp_path):
    """Without --device the commands want cuda; with no card they raise
    rather than run on the CPU."""
    from esa_pose_estimation_tpu_torch.cli import (
        eval_synthetic,
        evaluate,
        mfu_experiments,
        submit,
        train,
        train_detector,
        train_linemod,
    )
    from esa_pose_estimation_tpu_torch.utils import artifact
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    art = ['--artifact', 'artifacts/esa_syn_r5.npz']
    for main, argv in (
            (train.main, ['--workdir', str(tmp_path / 'r'), '--tiny']),
            (train_detector.main, ['--workdir', str(tmp_path / 'd')]),
            (train_linemod.main, ['--workdir', str(tmp_path / 'l')]),
            (eval_synthetic.main, art),
            (evaluate.main, art + ['--test-pkl', 'none.pkl']),
            (submit.main, art + ['--test-pkl', 'none.pkl']),
            (artifact.main, ['--workdir', str(tmp_path), '--out',
                             str(tmp_path / 'x.npz')]),
            (mfu_experiments.main, ['--model-axis', '--workdir',
                                    str(tmp_path / 'm')])):
        with pytest.raises(RuntimeError, match='cuda requested'):
            main(argv)
    assert not (tmp_path / 'r' / 'net_esa').exists()
    assert not (tmp_path / 'd').exists()
    assert not (tmp_path / 'l').exists()
    assert not (tmp_path / 'm').exists()


def test_native_loader_builds_only_the_checkout_source(monkeypatch,
                                                      tmp_path):
    """The loader's build compiles native/src/shard_loader.cpp of this
    checkout, and no other source, against the libpng headers kept in the
    package, into a temporary name that is then renamed into the build
    directory."""
    import subprocess
    import types

    from esa_pose_estimation_tpu_torch.data import native_loader
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index('-o') + 1]).write_bytes(b'')
        return types.SimpleNamespace(returncode=0, stderr='')

    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(subprocess, 'run', fake_run)
    lib = native_loader.build_library()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == 'g++'
    sources = [a for a in cmd if a.endswith(('.cpp', '.cc', '.c', '.cu'))]
    assert sources == [str(ROOT / 'native' / 'src' / 'shard_loader.cpp')]
    includes = [a[2:] for a in cmd if a.startswith('-I')]
    assert includes == [str(ROOT / 'esa_pose_estimation_tpu_torch' /
                            'third_party' / 'libpng')]
    assert Path(includes[0], 'png.h').is_file()
    out = Path(cmd[cmd.index('-o') + 1])
    assert out.parent == lib.parent == tmp_path / 'build'
    assert out != lib and lib.exists() and not out.exists()
    assert native_loader.build_library() == lib and len(calls) == 1
