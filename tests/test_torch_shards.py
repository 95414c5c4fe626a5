"""SPD1 shards (``data/shards.py``) and the native loader's binding
(``data/native_loader.py``) of the port against the JAX package.

The writers are held to byte equality and each side reads the other's
files.  The loaders are compared batch for batch on one shard: records,
order, epochs, ``drop_last`` and process slices exactly.  The JAX binding
runs on the library the port builds from the same
``native/src/shard_loader.cpp``, so that no test writes into
``native/build/`` while ``tests/test_native_loader.py`` may build there
in another worker.  Host crops are held to the port's ``ops/crop`` at atol
0.05 grey levels (the C++ box rule and resample in f32 and f64 against
the f32 device path, the JAX test's tolerance), rates at rtol 1e-6 and
origins exactly.
"""

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.data import native_loader as jnl
from esa_pose_estimation_tpu.data import shards as jshards
from esa_pose_estimation_tpu_torch.data import native_loader as tnl
from esa_pose_estimation_tpu_torch.data import shards as tshards
from esa_pose_estimation_tpu_torch.data.pipeline import (
    build_batch,
    build_shard_batch,
)
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(n=10, h=60, w=96, k=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x1, y1 = rng.uniform(2, 40), rng.uniform(2, 20)
        bw, bh = rng.uniform(10, 50), rng.uniform(10, 35)
        out.append(dict(
            name=f'img{i:03d}.png',
            frame=rng.integers(0, 255, size=(h, w), dtype=np.uint8),
            bbox=np.array([x1, y1, x1 + bw, y1 + bh], np.float32),
            keypoints_2d=rng.uniform(0, 60, (k, 2)).astype(np.float32),
            quat=rng.normal(size=4).astype(np.float32),
            trans=rng.normal(size=3).astype(np.float32)))
    return out


def _write(mod, path, recs, compressed, h=60, w=96, k=5):
    with mod.ShardWriter(str(path), h, w, k, compressed=compressed) as sw:
        for r in recs:
            sw.add(r['name'], r['frame'], r['bbox'], r['keypoints_2d'],
                   r['quat'], r['trans'])
    return str(path)


@pytest.fixture
def jax_on_port_library(monkeypatch):
    """The JAX binding, loading the port's build of the same source."""
    path = str(tnl.build_library())
    monkeypatch.setattr(jnl, '_LIB', None)
    monkeypatch.setattr(jnl, 'build_library', lambda force=False: path)
    return jnl


@pytest.mark.parametrize('compressed', [False, True])
def test_writers_are_byte_identical(tmp_path, compressed):
    recs = _records()
    a = _write(tshards, tmp_path / 'port.spd', recs, compressed)
    b = _write(jshards, tmp_path / 'jax.spd', recs, compressed)
    assert open(a, 'rb').read() == open(b, 'rb').read()
    assert tshards.read_meta(a) == tshards.ShardMeta(10, 60, 96, 5,
                                                     compressed)


def _batches(loader):
    return [{k: (v if isinstance(v, list) else np.asarray(v))
             for k, v in b.items()} for b in loader]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize('compressed', [False, True])
def test_each_side_reads_the_others_shard(tmp_path, compressed,
                                          jax_on_port_library):
    recs = _records(n=6)
    port_file = _write(tshards, tmp_path / 'port.spd', recs, compressed)
    jax_file = _write(jshards, tmp_path / 'jax.spd', recs, compressed)
    assert jshards.read_meta(port_file).__dict__ == \
        tshards.read_meta(jax_file).__dict__
    kw = dict(batch_size=3, shuffle=False, n_threads=2)
    got = _batches(tnl.NativeBatchLoader(jax_file, device='cpu', **kw))
    want = _batches(jax_on_port_library.NativeBatchLoader(port_file, **kw))
    _assert_same(got, want)
    frames = np.concatenate([b['frame'] for b in got])
    np.testing.assert_array_equal(frames, np.stack([r['frame']
                                                    for r in recs]))


LOADER_CASES = {
    'in order': dict(batch_size=4, shuffle=False),
    'shuffled, two epochs': dict(batch_size=4, shuffle=True, seed=7),
    'keep the last': dict(batch_size=4, shuffle=True, seed=3,
                          drop_last=False),
    'process 1 of 3': dict(batch_size=2, shuffle=True, seed=5,
                           process_id=1, process_count=3),
    'process 2 of 3, last kept': dict(batch_size=2, shuffle=False,
                                      drop_last=False, process_id=2,
                                      process_count=3),
    'host crop': dict(batch_size=4, shuffle=True, seed=1, crop_size=16),
}


@pytest.mark.parametrize('case', list(LOADER_CASES))
def test_loader_yields_what_jax_yields(tmp_path, case, jax_on_port_library):
    path = _write(tshards, tmp_path / 's.spd', _records(n=11), False)
    kw = LOADER_CASES[case]
    port = tnl.NativeBatchLoader(path, n_threads=3, device='cpu', **kw)
    ref = jax_on_port_library.NativeBatchLoader(path, n_threads=3, **kw)
    assert len(port) == len(ref) and port.n_local == ref.n_local
    for _ in range(2):                              # two epochs
        got, want = _batches(port), _batches(ref)
        assert len(got) == len(port)
        _assert_same(got, want)
    port.close()
    ref.close()


@pytest.mark.parametrize('compressed', [False, True])
def test_host_crop_matches_the_device_crop(tmp_path, compressed):
    recs = _records(n=6)
    path = _write(tshards, tmp_path / 's.spd', recs, compressed)
    frames = torch.from_numpy(np.stack([r['frame'] for r in recs]))
    boxes = torch.from_numpy(np.stack([r['bbox'] for r in recs]))
    crops, rates, origins = crop_ops.crop_resize(frames.float(), boxes, 32,
                                                 img_w=96, img_h=60)
    with tnl.NativeBatchLoader(path, 6, shuffle=False, crop_size=32,
                               device='cpu') as loader:
        b = next(iter(loader))
    assert 'frame' not in b and b['crop'].dtype == torch.float32
    np.testing.assert_allclose(b['rate'].numpy(), rates.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(b['origin'].numpy(),
                                  origins.numpy().astype(np.float32))
    np.testing.assert_allclose(b['crop'].numpy(), crops.numpy(), atol=0.05,
                               rtol=0)


def test_shard_batches_build_like_the_device_route(tmp_path):
    """A loader batch through ``build_shard_batch``: frames give exactly
    ``build_batch``'s batch; host crops give its targets and, on SPEED
    sized frames (the box rule clamps to 1920x1200), its images within
    0.05 grey levels."""
    rng = np.random.default_rng(1)
    recs = _records(n=4, h=1200, w=1920, k=6, seed=2)
    for r in recs:
        r['bbox'] = (r['bbox'] * 8).astype(np.float32)
        r['keypoints_2d'] = (r['bbox'][:2] + rng.uniform(
            0, 80, (6, 2))).astype(np.float32)
    path = _write(tshards, tmp_path / 's.spd', recs, False, 1200, 1920, 6)
    draws = {'jitter': {'brightness': torch.full((4,), 1.05),
                        'contrast': torch.full((4,), 0.95),
                        'order': torch.tensor([True, False, True, False])}}
    with tnl.NativeBatchLoader(path, 4, shuffle=False, device='cpu') as ld:
        frames = next(iter(ld))
    with tnl.NativeBatchLoader(path, 4, shuffle=False, crop_size=64,
                               device='cpu') as ld:
        crops = next(iter(ld))
    want = build_batch(frames['frame'].float(), frames['bbox'],
                       frames['keypoints_2d'], crop_size=64, draws=draws)
    got = build_shard_batch(frames, crop_size=64, draws=draws)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    got = build_shard_batch(crops, crop_size=64, draws=draws)
    for k in ('heatmaps', 'weights', 'keypoints_crop', 'rate'):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-5)
    # images are normalized: 0.05 grey levels is 0.05 / 255 / 0.229
    torch.testing.assert_close(got['image'], want['image'], rtol=0,
                               atol=0.05 / 255 / 0.229 * 1.05)


def test_truncated_shard_raises(tmp_path):
    path = _write(tshards, tmp_path / 's.spd', _records(n=4), False)
    data = open(path, 'rb').read()
    with open(path, 'wb') as f:
        f.write(data[:-500])
    with pytest.raises((RuntimeError, OSError), match='shard'):
        with tnl.NativeBatchLoader(path, 2, shuffle=False,
                                   device='cpu') as loader:
            list(loader)
    with open(path, 'wb') as f:
        f.write(b'XXXX' + data[4:])
    with pytest.raises(ValueError, match='not an SPD1 shard'):
        tnl.NativeBatchLoader(path, 2, device='cpu')


def test_loader_refuses_a_cuda_device_without_a_card(tmp_path, monkeypatch):
    path = _write(tshards, tmp_path / 's.spd', _records(n=2), False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda requested'):
        tnl.NativeBatchLoader(path, 2)


def test_synthetic_shard_reads_in_both_packages(tmp_path,
                                                jax_on_port_library):
    path = str(tmp_path / 'syn.spd')
    assert tshards.write_synthetic_shard(path, 5, height=96, width=160,
                                         n_kp=30, batch=2,
                                         device='cpu') == 5
    meta = jshards.read_meta(path)
    assert (meta.n_records, meta.height, meta.width, meta.n_kp) == (
        5, 96, 160, 30)
    got = _batches(tnl.NativeBatchLoader(path, 5, shuffle=False,
                                         device='cpu'))
    want = _batches(jax_on_port_library.NativeBatchLoader(path, 5,
                                                          shuffle=False))
    _assert_same(got, want)
    b = got[0]
    assert b['name'] == [f'synth{i:06d}.png' for i in range(5)]
    assert b['frame'].max() > 100 and np.isfinite(b['keypoints_2d']).all()
    # keypoints lie inside their boxes' 12-pixel margins
    lo = b['bbox'][:, None, :2] - 1e-3
    hi = b['bbox'][:, None, 2:] + 1e-3
    inside = ((b['keypoints_2d'] >= lo) & (b['keypoints_2d'] <= hi)).all(-1)
    visible = ((b['keypoints_2d'] >= 0) & (b['keypoints_2d'] <= [159, 95])
               ).all(-1)
    assert inside[visible].all()


@pytest.mark.parametrize('compressed', [False, True])
def test_shard_from_records_is_byte_identical(tmp_path, compressed):
    """``write_shard_from_records`` over PNG frames on disk, in both
    packages, and the port's loader reads the frames back."""
    import types

    from PIL import Image
    recs = _records(n=3)
    out = []
    for r in recs:
        path = tmp_path / r['name']
        Image.fromarray(r['frame']).save(path)
        out.append(types.SimpleNamespace(
            image_path=str(path), name=r['name'], bbox=r['bbox'],
            keypoints_2d=r['keypoints_2d'], quat=r['quat'],
            trans=r['trans']))
    a, b = str(tmp_path / 'port.spd'), str(tmp_path / 'jax.spd')
    kw = dict(height=60, width=96, compressed=compressed)
    assert tshards.write_shard_from_records(a, out, **kw) == 3
    jshards.write_shard_from_records(b, out, **kw)
    assert open(a, 'rb').read() == open(b, 'rb').read()
    with tnl.NativeBatchLoader(a, 3, shuffle=False, device='cpu') as ld:
        frames = next(iter(ld))['frame'].numpy()
    np.testing.assert_array_equal(frames, np.stack([r['frame']
                                                    for r in recs]))
