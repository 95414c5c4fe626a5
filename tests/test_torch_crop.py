"""Crop stage of the port (``ops/crop.py``) against the JAX package.

Tolerance: box origins, crop sizes, square sizes and rates exactly equal
(integer arithmetic and one f32 division); crops atol 1e-3 on 0-255 values
(the same two f32 tent-weight products, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.ops import crop as jcrop
from esa_pose_estimation_tpu_torch.ops import crop as tcrop


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(w, h):
    """Interior, edge-touching and larger-than-frame boxes (x1, y1, x2, y2)."""
    return np.array([
        [0.3 * w, 0.35 * h, 0.55 * w, 0.6 * h],      # interior
        [0.0, 0.0, 0.2 * w, 0.3 * h],                # top-left corner
        [0.8 * w, 0.7 * h, w - 1.0, h - 1.0],        # bottom-right corner
        [0.05 * w, 0.4 * h, 0.95 * w, 0.6 * h],      # wider than tall
        [0.45 * w, 0.0, 0.55 * w, h - 1.0],          # full-height strip
        [-5.0, -3.0, w + 4.0, h + 2.0],              # past the frame
        [10.25, 20.75, 97.5, 61.125],                # fractional corners
    ], np.float32)


@pytest.mark.parametrize('force_square', [True, False])
@pytest.mark.parametrize('wh', [(320, 240), (1920, 1200)])
def test_adjust_bbox_exact(force_square, wh):
    w, h = wh
    b = _boxes(w, h)
    want = jcrop.adjust_bbox(jnp.asarray(b), w, h, force_square=force_square)
    got = tcrop.adjust_bbox(torch.from_numpy(b), w, h,
                            force_square=force_square)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize('rule', ['train', 'val'])
def test_crop_resize_matches(rule):
    w, h = 320, 240
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, size=(7, h, w)).astype(np.float32)
    b = _boxes(w, h)
    kw = dict(img_w=w, img_h=h, force_square=rule == 'train')
    cj, rj, oj = jcrop.crop_resize(jnp.asarray(frames), jnp.asarray(b), 64,
                                   **kw)
    ct, rt, ot = tcrop.crop_resize(torch.from_numpy(frames),
                                   torch.from_numpy(b), 64, **kw)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-3,
                               rtol=0)


def test_crop_full_frame_channels():
    """Full 1920x1200 geometry with a channel axis (B, H, W, C)."""
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, size=(2, 1200, 1920, 2)).astype(np.float32)
    b = _boxes(1920, 1200)[[2, 3]]
    cj, rj, oj = jcrop.crop_resize(jnp.asarray(frames), jnp.asarray(b), 128)
    ct, rt, ot = tcrop.crop_resize(torch.from_numpy(frames),
                                   torch.from_numpy(b), 128)
    assert ct.shape == (2, 128, 128, 2)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-3,
                               rtol=0)


def test_kmul_table_and_normalize():
    assert tcrop._kmul_table(1.05, 600) == jcrop._kmul_table(1.05, 600)
    assert tcrop._kmul_table(1.1, 600) == jcrop._kmul_table(1.1, 600)
    x = np.linspace(0, 255, 50, dtype=np.float32)
    np.testing.assert_array_equal(
        tcrop.normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jcrop.normalize(jnp.asarray(x))))
