"""Mask and depth rasterization and the viewpoint samplers of the port
(``utils/render.py``) against the JAX package.

Tolerances:
- ``sample_sphere_points``, ``sample_poses`` and ``pose_statistics``:
  equal (the same host numpy);
- ``rasterize``: masks equal except on pixels that lie on a triangle edge
  (an edge function within 1e-3 px^2 of zero): there XLA's CPU code
  contracts ``(bx - ax) * (cy - ay) - (by - ay) * (cx - ax)`` into a fused
  multiply-add and torch does not, so the sign of a value near zero can
  differ; this is the compilers' rounding, not a port fault.  The test
  counts those pixels (at most 0.5% of the covered ones; measured: 0 of
  5277 on the icosphere's 24 poses at 64 px, printed by the test) and
  requires every differing pixel to be such an edge pixel.  Depth: rtol
  1e-5 where both masks cover, +inf where neither does;
- a batch of poses in one call equals the same poses one at a time
  (bit-equal);
- the square, winding, depth-order, near-plane and perspective-correct
  cases of tests/test_render.py: masks equal but for edge pixels (the
  square's diagonal passes through pixel centres: 2 pixels there), depth
  atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.cli.train_linemod import make_icosphere
from esa_pose_estimation_tpu.core import camera as jcam
from esa_pose_estimation_tpu.utils import render as jrender
from esa_pose_estimation_tpu_torch.utils import render as trender


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return np.asarray(a)


def test_samplers_equal():
    for seed in (0, 3):
        np.testing.assert_array_equal(trender.sample_sphere_points(50, seed),
                                      jrender.sample_sphere_points(50, seed))
        Rt, tt = trender.sample_poses(16, 0.5, 2.0, seed)
        Rj, tj = jrender.sample_poses(16, 0.5, 2.0, seed)
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
        st = trender.pose_statistics(Rt, tt)
        sj = jrender.pose_statistics(Rj, tj)
        assert st.keys() == sj.keys()
        for k in st:
            np.testing.assert_array_equal(st[k], sj[k])


def _edge_distance(verts, faces, R, t, K, h, w):
    """Per pixel: the smallest |edge function| over the triangles whose
    other two edge tests pass (in f64): near zero on a triangle edge."""
    cam = verts @ R.T + t
    uv = cam[:, :2] / cam[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    px, py = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    best = np.full((h, w), np.inf)
    for tri in faces:
        a, b, c = uv[tri]

        def e(p, q):
            return (q[0] - p[0]) * (py - p[1]) - (q[1] - p[1]) * (px - p[0])
        area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        s = 1.0 if area >= 0 else -1.0
        ws = [e(b, c) * s, e(c, a) * s, e(a, b) * s]
        for i in range(3):
            others = [ws[j] for j in range(3) if j != i]
            near = (others[0] >= -1e-3) & (others[1] >= -1e-3)
            best = np.where(near, np.minimum(best, np.abs(ws[i])), best)
    return best


def test_rasterize_icosphere_against_jax():
    verts, faces = make_icosphere()
    size = 64
    K = (jcam.LINEMOD_K * (size / 640.0)).astype(np.float32)
    K[2, 2] = 1.0
    rng = np.random.default_rng(0)
    q = rng.normal(size=(24, 4)).astype(np.float32)
    from esa_pose_estimation_tpu_torch.core.camera import quat_to_rotmat
    R = quat_to_rotmat(T(q)).numpy()
    t = np.zeros((24, 3), np.float32)
    t[:, 2] = rng.uniform(0.35, 0.55, 24)
    jr = jax.jit(jax.vmap(lambda r, tt: jrender.rasterize(
        jnp.asarray(verts), jnp.asarray(faces), r, tt, jnp.asarray(K),
        size, size)))
    jm, jd = (N(a) for a in jr(jnp.asarray(R), jnp.asarray(t)))
    tm, td = trender.rasterize(T(verts), T(faces), T(R), T(t), T(K), size,
                               size)
    tm, td = tm.numpy(), td.numpy()
    differ = tm != jm
    n_diff, n_cov = int(differ.sum()), int((tm | jm).sum())
    print(f'rasterize: {n_diff} of {n_cov} covered pixels differ from JAX '
          f'(all on triangle edges)')
    assert n_diff <= 0.005 * n_cov
    for i in np.unique(np.nonzero(differ)[0]):
        dist = _edge_distance(verts.astype(np.float64), faces,
                              R[i].astype(np.float64), t[i], K, size, size)
        assert (dist[differ[i]] < 1e-3).all()
    both = tm & jm
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5)
    assert np.isinf(td[~tm]).all() and np.isinf(jd[~jm]).all()
    # one call for the batch equals one call per pose
    for i in (0, 5):
        m1, d1 = trender.rasterize(T(verts), T(faces), T(R[i]), T(t[i]),
                                   T(K), size, size)
        np.testing.assert_array_equal(m1.numpy(), tm[i])
        np.testing.assert_array_equal(d1.numpy(), td[i])


@pytest.mark.parametrize('case', ['square', 'winding', 'order', 'near',
                                  'slanted'])
def test_rasterize_cases_against_jax(case):
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    R, t = np.eye(3, dtype=np.float32), np.array([0.0, 0, 1.0], np.float32)
    if case == 'square':
        verts = np.array([[-0.1, -0.1, 0.0], [0.1, -0.1, 0], [0.1, 0.1, 0],
                          [-0.1, 0.1, 0]], np.float32)
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    elif case == 'winding':
        verts = np.array([[-0.05, -0.05, 0.0], [0.05, -0.05, 0],
                          [0.0, 0.05, 0]], np.float32)
        faces = np.array([[0, 2, 1]], np.int32)
    elif case == 'order':          # two overlapping triangles at two depths
        verts = np.array([[-0.1, -0.1, 0.5], [0.1, -0.1, 0.5],
                          [0.0, 0.1, 0.5], [-0.1, -0.1, 0.0],
                          [0.1, -0.1, 0.0], [0.0, 0.1, 0.0]], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    elif case == 'near':           # a vertex behind the camera: dropped
        verts = np.array([[-0.1, -0.1, 0.0], [0.1, -0.1, 0.0],
                          [0.0, 0.1, -1.5]], np.float32)
        faces = np.array([[0, 1, 2]], np.int32)
    else:                          # a slanted face: perspective-correct z
        verts = np.array([[-0.2, -0.2, -0.3], [0.2, -0.2, 0.6],
                          [0.0, 0.2, 0.1]], np.float32)
        faces = np.array([[0, 1, 2]], np.int32)
    jm, jd = jrender.rasterize(jnp.asarray(verts), jnp.asarray(faces),
                               jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(K), 64, 64)
    tm, td = trender.rasterize(T(verts), T(faces), T(R), T(t), T(K), 64, 64)
    tm, td, jm, jd = tm.numpy(), td.numpy(), N(jm), N(jd)
    differ = tm != jm
    if differ.any():               # only where an edge crosses a centre
        dist = _edge_distance(verts.astype(np.float64), faces, R, t, K, 64,
                              64)
        assert (dist[differ] < 1e-3).all(), case
        assert differ.sum() <= 4, case
    both = tm & jm
    np.testing.assert_allclose(td[both], jd[both], atol=1e-5)
    assert np.isinf(td[~tm]).all()
    mask_np = trender.rasterize_mask(verts, faces, np.concatenate(
        [R, t[:, None]], 1), K, 64, 64)
    np.testing.assert_array_equal(mask_np, tm)


def test_chunk_bounds_memory():
    assert trender._bounded_chunk(512, 1, 1200, 1920) == \
        jrender._bounded_chunk(512, 1200, 1920)
    assert trender._bounded_chunk(512, 16, 128, 128) == 64
    verts, faces = make_icosphere()
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    R = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    t = np.array([[0, 0, 0.5], [0.01, 0, 0.4]], np.float32)
    full = trender.rasterize(T(verts), T(faces), T(R), T(t), T(K), 64, 64)
    small = trender.rasterize(T(verts), T(faces), T(R), T(t), T(K), 64, 64,
                              chunk=7)
    for a, b in zip(full, small):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rasterize_color_against_jax():
    """Shaded colour of the icosphere with per-vertex colours under 12
    poses and a slanted light: masks as ``rasterize`` (equal off triangle
    edges), depth rtol 1e-5 where both cover, colour within 1e-5 except on
    pixels within 1e-3 px^2 of a triangle edge (there the two may pick
    the other triangle of the edge; at most 1% of the covered pixels).
    ``render_color`` is the uint8 of the colour (within 1 level of JAX's
    off those pixels), and a batch equals its poses one at a time."""
    verts, faces = make_icosphere()
    size = 48
    K = (jcam.LINEMOD_K * (size / 640.0)).astype(np.float32)
    K[2, 2] = 1.0
    rng = np.random.default_rng(5)
    vc = rng.uniform(0.2, 1.0, verts.shape).astype(np.float32)
    q = rng.normal(size=(12, 4)).astype(np.float32)
    from esa_pose_estimation_tpu_torch.core.camera import quat_to_rotmat
    R = quat_to_rotmat(T(q)).numpy()
    t = np.zeros((12, 3), np.float32)
    t[:, 2] = rng.uniform(0.35, 0.55, 12)
    light = (0.3, -0.2, 1.0)
    jr = jax.jit(jax.vmap(lambda r, tt: jrender.rasterize_color(
        jnp.asarray(verts), jnp.asarray(faces), r, tt, jnp.asarray(K),
        size, size, jnp.asarray(vc), light_dir=light)))
    jc, jd, jm = (N(a) for a in jr(jnp.asarray(R), jnp.asarray(t)))
    tc, td, tm = (a.numpy() for a in trender.rasterize_color(
        T(verts), T(faces), T(R), T(t), T(K), size, size, T(vc),
        light_dir=light))
    n_cov = int((tm | jm).sum())
    far = np.abs(tc - jc).max(-1) > 1e-5
    bad = (tm != jm) | far
    print(f'rasterize_color: {int(bad.sum())} of {n_cov} covered pixels '
          f'differ from JAX (all on triangle edges)')
    assert bad.sum() <= 0.01 * n_cov
    for i in np.unique(np.nonzero(bad)[0]):
        dist = _edge_distance(verts.astype(np.float64), faces,
                              R[i].astype(np.float64), t[i], K, size, size)
        assert (dist[bad[i]] < 1e-3).all()
    both = tm & jm
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5)
    assert (tc[~tm] == 0).all() and np.isinf(td[~tm]).all()
    # the mask equals rasterize's
    m2, _ = trender.rasterize(T(verts), T(faces), T(R), T(t), T(K), size,
                              size)
    np.testing.assert_array_equal(m2.numpy(), tm)
    pose = np.concatenate([R, t[:, :, None]], -1)
    u8 = trender.render_color(verts, faces, pose, K, size, size, vc)
    assert u8.dtype == np.uint8 and u8.shape == (12, size, size, 3)
    ju8 = N(jrender.render_color(verts, faces, pose[0], K, size, size, vc))
    diff = np.abs(u8[0].astype(int) - ju8.astype(int)).max(-1)
    assert (diff[~bad[0]] <= 1).all()
    for i in (0, 7):
        ci, di, mi = trender.rasterize_color(
            T(verts), T(faces), T(R[i]), T(t[i]), T(K), size, size, T(vc),
            light_dir=light, chunk=17)
        np.testing.assert_array_equal(mi.numpy(), tm[i])
        np.testing.assert_array_equal(di.numpy(), td[i])
        np.testing.assert_array_equal(ci.numpy(), tc[i])
