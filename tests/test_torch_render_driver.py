"""``utils/render_driver.py`` of the port against the JAX package's (the
reference's Blender orchestration, render_utils.py:161-274), mirroring
tests/test_render_driver.py.

The command contract runs against a fake renderer (a python script that
parses the blender-style command and writes numbered PNGs and depth
``.npy`` files).  Tolerances: poses, Euler angles and the background list
equal JAX's; the fallback's masks equal JAX's except on pixels within
1e-3 px^2 of a triangle edge (XLA contracts the edge function into a
fused multiply-add and torch does not), and its shaded frames equal
JAX's within 1 grey level off those pixels.
"""

from __future__ import annotations

import os
import stat
import sys

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.cli.train_linemod import make_icosphere
from esa_pose_estimation_tpu.utils import render_driver as jrd
from esa_pose_estimation_tpu_torch.utils import render_driver as rd


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAKE_RENDERER = r'''#!{python}
import argparse, os, sys
import numpy as np
from PIL import Image

args = sys.argv[sys.argv.index('--') + 1:]
ap = argparse.ArgumentParser()
ap.add_argument('--input'); ap.add_argument('--output_dir')
ap.add_argument('--bg_imgs'); ap.add_argument('--poses_path')
ns = ap.parse_args(args)
poses = np.load(ns.poses_path)
assert len(np.load(ns.bg_imgs)) >= 1, 'background list empty'
os.makedirs(ns.output_dir, exist_ok=True)
for i in range(len(poses)):
    Image.fromarray(np.full((48, 64), i % 255, np.uint8)).save(
        os.path.join(ns.output_dir, f'{{i}}.png'))
    depth = np.ones((48, 64), np.float32); depth[10:30, 20:40] = 0.7
    np.save(os.path.join(ns.output_dir, f'{{i}}_depth.npy'), depth)
'''


@pytest.fixture()
def workspace(tmp_path):
    exe = tmp_path / 'fake_blender.py'
    exe.write_text(FAKE_RENDERER.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    from PIL import Image
    bg_dir = tmp_path / 'bg'
    bg_dir.mkdir()
    Image.fromarray(np.zeros((600, 700), np.uint8)).save(bg_dir / 'big.png')
    Image.fromarray(np.zeros((100, 100), np.uint8)).save(bg_dir / 'sm.png')
    (bg_dir / 'notes.txt').write_text('not an image')
    verts, faces = make_icosphere(subdiv=1)
    np.savez(tmp_path / 'obj.npz', vertices=verts, faces=faces)
    return tmp_path, str(exe)


def test_background_list_equals_jax(workspace):
    tmp, _ = workspace
    kept = rd.prepare_background_list(str(tmp / 'bg'), str(tmp / 'bg.npy'),
                                      min_size=500)
    assert kept == jrd.prepare_background_list(
        str(tmp / 'bg'), str(tmp / 'jbg.npy'), min_size=500)
    assert [os.path.basename(p) for p in kept] == ['big.png']
    assert list(np.load(tmp / 'bg.npy')) == kept


def test_euler_equal_jax():
    from esa_pose_estimation_tpu_torch.utils.render import sample_poses
    Rs, _ = sample_poses(16, 0.4, 1.0, seed=3)
    eul = rd.euler_from_rotmat(np.asarray(Rs))
    np.testing.assert_array_equal(eul, jrd.euler_from_rotmat(np.asarray(Rs)))
    back = np.stack([rd.euler_to_rotmat(e) for e in eul])
    np.testing.assert_array_equal(
        back, np.stack([jrd.euler_to_rotmat(e) for e in eul]))
    np.testing.assert_allclose(back, Rs, atol=1e-5)


def _job(tmp, mod, name, exe=None, **kw):
    return mod.ExternalRenderer(
        class_type=name, obj_path=str(tmp / 'obj.npz'),
        output_dir=str(tmp / 'renders' / name),
        poses_path=str(tmp / 'poses' / f'{name}_poses.npy'),
        bg_imgs_path=str(tmp / 'bg.npy'),
        renderer_exe=sys.executable if exe else None,
        blend_file=exe or '', **kw)


def test_external_run_end_to_end(workspace):
    tmp, exe = workspace
    rd.prepare_background_list(str(tmp / 'bg'), str(tmp / 'bg.npy'))
    job = _job(tmp, rd, 'cat', exe, n_poses=5, seed=1)
    assert job.command()[:4] == [sys.executable, exe, '--background', '--']
    assert job.run() == 5
    poses = np.load(job.poses_path)
    assert poses.shape == (5, 6)
    jpose = _job(tmp, jrd, 'jcat', exe, n_poses=5, seed=1).sample_poses()
    np.testing.assert_array_equal(poses, jpose)
    from PIL import Image
    d = np.asarray(Image.open(tmp / 'renders' / 'cat' / '0_depth.png'))
    assert set(np.unique(d)) == {0, 255}
    assert d[20, 30] == 255 and d[0, 0] == 0
    assert not list((tmp / 'renders' / 'cat').glob('*_depth.npy'))
    with pytest.raises(ValueError):
        _job(tmp, rd, 'x').command()


def test_multi_render_pool_spawns(workspace):
    tmp, exe = workspace
    rd.prepare_background_list(str(tmp / 'bg'), str(tmp / 'bg.npy'))
    jobs = [_job(tmp, rd, cls, exe, n_poses=3, seed=i)
            for i, cls in enumerate(('ape', 'duck'))]
    assert rd.multi_render(jobs, processes=2) == {'ape': 3, 'duck': 3}


def _edge_distance(verts, faces, R, t, K, h, w):
    """Per pixel (f64): the least |edge function| over the triangles
    whose other two edge tests pass: near zero on a triangle edge."""
    cam = verts @ R.T + t
    uv = cam[:, :2] / cam[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    px, py = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    best = np.full((h, w), np.inf)
    for tri in faces:
        a, b, c = uv[tri]
        x0, x1 = int(min(a[0], b[0], c[0])) - 2, int(max(a[0], b[0],
                                                         c[0])) + 3
        y0, y1 = int(min(a[1], b[1], c[1])) - 2, int(max(a[1], b[1],
                                                         c[1])) + 3
        x0, y0 = max(x0, 0), max(y0, 0)
        if x0 >= w or y0 >= h or x1 <= 0 or y1 <= 0:
            continue
        sx, sy = px[y0:y1, x0:x1], py[y0:y1, x0:x1]

        def e(p, q):
            return (q[0] - p[0]) * (sy - p[1]) - (q[1] - p[1]) * (sx - p[0])
        area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        s = 1.0 if area >= 0 else -1.0
        ws = [e(b, c) * s, e(c, a) * s, e(a, b) * s]
        for i in range(3):
            o = [ws[j] for j in range(3) if j != i]
            near = (o[0] >= -1e-3) & (o[1] >= -1e-3)
            sub = best[y0:y1, x0:x1]
            best[y0:y1, x0:x1] = np.where(near, np.minimum(sub,
                                                           np.abs(ws[i])),
                                          sub)
    return best


def test_fallback_matches_jax(workspace):
    """No renderer_exe: the port's batched rasterizer writes what the JAX
    fallback writes, but for triangle-edge pixels."""
    from PIL import Image
    tmp, _ = workspace
    tjob = _job(tmp, rd, 'cat', n_poses=3, seed=2, device='cpu')
    jjob = _job(tmp, jrd, 'jcat', n_poses=3, seed=2)
    assert tjob.run() == 3 and jjob.run() == 3
    verts, faces = rd._load_mesh(str(tmp / 'obj.npz'))
    poses = np.load(tjob.poses_path)
    np.testing.assert_array_equal(poses, np.load(jjob.poses_path))
    K = rd.RENDER_K['linemod']
    for i in range(3):
        img = np.asarray(Image.open(tmp / 'renders' / 'cat' / f'{i}.png'))
        msk = np.asarray(Image.open(tmp / 'renders' / 'cat' /
                                    f'{i}_depth.png'))
        jimg = np.asarray(Image.open(tmp / 'renders' / 'jcat' / f'{i}.png'))
        jmsk = np.asarray(Image.open(tmp / 'renders' / 'jcat' /
                                     f'{i}_depth.png'))
        assert img.shape == (480, 640) and msk.max() == 255
        assert (img > 0).sum() > 50
        differ = msk != jmsk
        off = np.abs(img.astype(int) - jimg.astype(int)) > 1
        if differ.any() or off.any():
            dist = _edge_distance(verts.astype(np.float64), faces,
                                  rd.euler_to_rotmat(poses[i, :3]).astype(
                                      np.float64), poses[i, 3:6], K, 480,
                                  640)
            assert (dist[differ | off] < 1e-3).all(), i
        assert differ.sum() <= 0.005 * (msk > 0).sum()


def test_ply_mesh_is_hulled(tmp_path):
    verts, _ = make_icosphere(subdiv=1)
    path = tmp_path / 'obj.ply'
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {len(verts)}\nproperty float x\n'
                'property float y\nproperty float z\nend_header\n')
        for v in verts:
            f.write(f'{v[0]} {v[1]} {v[2]}\n')
    v, faces = rd._load_mesh(str(path))
    jv, jfaces = jrd._load_mesh(str(path))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(faces, jfaces)
