"""``obs/visual.py`` of the port against the JAX package's, and the eval
panels of ``cli/train``.

Tolerances: ``bb8_corners`` and ``covariance_ellipse`` equal JAX's
exactly (the same numpy); projected pose axes within 1e-3 px; a panel is
a PNG of the expected pixel size; ``cli.train --tiny --device cpu``
writes ``n_panels`` (4) PNGs per eval, and none with ``--no-panels``.
"""

import os

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.obs import visual as jvis
from esa_pose_estimation_tpu_torch.data import linemod as tlm
from esa_pose_estimation_tpu_torch.obs import visual as tvis


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bb8_corners_is_one_function_and_equals_jax():
    assert tlm.bb8_corners is tvis.bb8_corners
    pts = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(tvis.bb8_corners(pts),
                                  jvis.bb8_corners(pts))


def test_covariance_ellipse_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = rng.normal(size=(2, 2))
        cov, mean = a @ a.T, rng.normal(size=2)
        for n_std in (1.0, 2.0):
            got = tvis.covariance_ellipse(mean, cov, n_std)
            want = jvis.covariance_ellipse(mean, cov, n_std)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_project_axes_match_jax():
    import jax.numpy as jnp

    from esa_pose_estimation_tpu.core.camera import project_axes
    q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
    q /= np.linalg.norm(q)
    r = np.array([0.3, -0.2, 9.0], np.float32)
    got = tvis.project_axes(q, r)
    want = project_axes(jnp.asarray(q), jnp.asarray(r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3)


def test_save_eval_panel_and_drawings(tmp_path):
    pytest.importorskip('matplotlib')
    from PIL import Image
    rng = np.random.default_rng(2)
    frame = rng.uniform(0, 255, (60, 80))
    kp = rng.uniform(5, 55, (6, 2))
    path = tvis.save_eval_panel(
        str(tmp_path / 'p.png'), frame, kp_pred=kp, kp_gt=kp + 1,
        heatmaps=rng.uniform(size=(16, 16, 6)), bbox=[5, 5, 60, 50],
        corners_pred=rng.uniform(5, 55, (8, 2)), title='t')
    with Image.open(path) as im:
        assert im.format == 'PNG' and im.size == (1320, 462)
    ax = tvis.visualize_bounding_box(
        frame, rng.uniform(5, 55, (8, 2)), rng.uniform(5, 55, (8, 2)),
        save=True, save_fn=str(tmp_path / 'bb8.png'))
    assert os.path.exists(tmp_path / 'bb8.png')
    tvis.draw_pose_axes(ax, np.array([1.0, 0, 0, 0]), np.array([0, 0, 9.0]))
    tvis.draw_keypoints(ax, kp, scores=rng.uniform(size=6))
    tvis.draw_covariance_ellipses(ax, kp[:2], np.stack([np.eye(2)] * 2))
    tvis.overlay_mask(ax, frame, frame > 128)
    assert len(ax.patches) == 3 + 2          # three arrows, two ellipses


@pytest.mark.parametrize('panels', [True, False])
def test_train_writes_eval_panels(tmp_path, panels):
    pytest.importorskip('matplotlib')
    from esa_pose_estimation_tpu_torch.cli import train
    wd = tmp_path / 'run'
    train.main(['--workdir', str(wd), '--tiny', '--epochs', '1',
                '--batch-size', '4', '--crop-size', '32', '--synthetic-size',
                '8', '--eval-every', '1', '--device', 'cpu']
               + ([] if panels else ['--no-panels']))
    pdir = wd / 'panels' / 'epoch001'
    if panels:
        assert sorted(os.listdir(pdir)) == [f'frame{j:02d}.png'
                                            for j in range(4)]
        import json
        evals = [json.loads(line) for line in open(wd / 'events.jsonl')
                 if '"eval"' in line]
        assert evals[0]['panel_dir'] == str(pdir)
    else:
        assert not (wd / 'panels').exists()
