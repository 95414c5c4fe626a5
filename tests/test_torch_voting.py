"""RANSAC voting, the voting distributions and their variants, the vertex
field, and uncertainty PnP of the port against the JAX package, with JAX's
Gumbel draws and RANSAC masks injected.

Tolerances:
- the fixed-budget gather (coords, dirs, weights): equal;
- hypotheses: rtol 1e-5, atol 1e-4 px (line intersections, some far out);
- vote counts: integer sums of ``cos > threshold`` tests, where a last-bit
  difference near the threshold flips a vote; at most 0.5% of the
  (hypothesis, keypoint) counts may differ, each by at most 2 votes
  (measured: none on the exact field, 1 of 576 counts by one vote on the
  0.01 rad field);
- ``ransac_voting`` on the exact and low-noise fields of
  tests/test_voting.py, where the winner is clear: keypoints atol 2e-3 px
  (measured 9.2e-4: the 2x2 normal equations sum ~1000 products of
  pixel coordinates in f32, in another order), inlier counts within 2;
  mean and covariance atol 1e-2 (rtol 1e-2 for the covariance): the
  ratio-thresholded moments carry the flipped votes into which
  hypotheses pass ``max - 0.1`` (measured 6.7e-3 px and 3.8e-3 px^2 on
  the noisy field, 8e-6 on the exact one); the 0.99 distributions
  around a given mean: rtol 1e-3 plus atol 1e-3;
- the moments on JAX's cloud: rtol 1e-5; the variants: motion atol 1e-4
  px, center and vanishing point atol 1e-3;
- ``vertex_field`` atol 1e-6, ``vertex_loss`` rtol 1e-6;
- ``cov_to_weight`` rtol 1e-5; ``uncertainty_pnp``, ``solve_pose`` and
  ``lm_refine_single`` on JAX's masks: rotations within 1e-3 degrees,
  translations atol 1e-4 (the LM's f32 steps in another summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.core import camera as jcam
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu.ops import vertex as jvert
from esa_pose_estimation_tpu.ops import voting as jvot
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.ops import vertex as tvert
from esa_pose_estimation_tpu_torch.ops import voting as tvot
from tests.test_voting import make_field


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return np.asarray(a)


def jax_draws(key, b, p, n_points, n_hyp):
    """The Gumbel noise JAX's voting draws from ``key``."""
    kg, kh = jax.random.split(key)
    n = min(n_points, p)
    return {'gather': T(jax.random.gumbel(kg, (b, p), dtype=jnp.float32)),
            'pairs': T(jax.random.gumbel(kh, (b, n_hyp, 2, n)))}


def _fields(noise):
    """A batch of two 64x64 fields, three keypoints each, one outside its
    mask."""
    kps = [np.array([[40.0, 25.0], [12.5, 50.25], [60.0, 10.0]], np.float32),
           np.array([[30.0, 30.0], [45.0, 20.0], [70.0, 70.0]], np.float32)]
    boxes = [(5, 5, 60, 60), (8, 4, 40, 44)]
    ms, vs = zip(*(make_field(64, 64, k, bx, noise=noise, seed=i)
                   for i, (k, bx) in enumerate(zip(kps, boxes))))
    return (np.concatenate([N(m) for m in ms]),
            np.concatenate([N(v) for v in vs]), np.stack(kps))


def _assert_counts_close(got, want):
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 5e-3, (diff > 0).mean()
    assert diff.max() <= 2.0, diff.max()


@pytest.mark.parametrize('noise', [0.0, 0.01])
def test_voting_internals_on_jax_draws(noise):
    mask, vertex, _ = _fields(noise)
    key = jax.random.PRNGKey(7)
    kg, kh = jax.random.split(key)
    d = jax_draws(key, 2, 64 * 64, 1024, 96)
    jc, jd, jw = jvot._gather_foreground(jnp.asarray(mask),
                                         jnp.asarray(vertex), kg, 1024)
    tc, td, tw = tvot._gather_foreground(T(mask), T(vertex), d['gather'],
                                         1024)
    for g, w in ((tc, jc), (td, jd), (tw, jw)):
        np.testing.assert_array_equal(g.numpy(), N(w))
    jh = jvot._generate_hypotheses(kh, jc, jd, jw, 96)
    th = tvot._generate_hypotheses(d['pairs'], tc, td, tw)
    np.testing.assert_allclose(th.numpy(), N(jh), rtol=1e-5, atol=1e-4)
    for thr, chunk in ((0.999, 32), (0.99, 40)):
        want = N(jvot._vote_counts_chunked(jh, jc, jd, jw, thr, chunk))
        got = tvot._vote_counts_chunked(T(N(jh)), tc, td, tw, thr,
                                        chunk).numpy()
        _assert_counts_close(got, want)


@pytest.mark.parametrize('noise', [0.0, 0.01])
def test_ransac_voting_on_jax_draws(noise):
    mask, vertex, kps = _fields(noise)
    key = jax.random.PRNGKey(11)
    want = jvot.ransac_voting(jnp.asarray(mask), jnp.asarray(vertex), key,
                              n_points=1024)
    got = tvot.ransac_voting(T(mask), T(vertex), n_points=1024,
                             draws=jax_draws(key, 2, 64 * 64, 1024, 128))
    np.testing.assert_allclose(got.keypoints.numpy(), N(want.keypoints),
                               atol=2e-3)
    np.testing.assert_allclose(got.mean.numpy(), N(want.mean), atol=1e-2)
    np.testing.assert_allclose(got.covariance.numpy(), N(want.covariance),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.inlier_counts.numpy(),
                               N(want.inlier_counts), atol=2.0)
    if noise == 0.0:
        np.testing.assert_allclose(got.keypoints.numpy(), kps, atol=0.1)


def test_distributions_on_jax_draws():
    mask, vertex, kps = _fields(0.01)
    key = jax.random.PRNGKey(12)
    mean = jnp.asarray(kps + 0.3)
    want = jvot.estimate_voting_distribution_with_mean(
        jnp.asarray(mask), jnp.asarray(vertex), mean, key, n_hypotheses=256,
        n_points=1024)
    got = tvot.estimate_voting_distribution_with_mean(
        T(mask), T(vertex), T(N(mean)), n_hypotheses=256, n_points=1024,
        draws=jax_draws(key, 2, 64 * 64, 1024, 256))
    np.testing.assert_array_equal(got[0].numpy(), N(mean))
    np.testing.assert_allclose(got[1].numpy(), N(want[1]), rtol=1e-3,
                               atol=1e-3)
    want = jvot.estimate_voting_distribution(
        jnp.asarray(mask), jnp.asarray(vertex), key, n_hypotheses=256,
        n_points=1024, topk=64)
    got = tvot.estimate_voting_distribution(
        T(mask), T(vertex), n_hypotheses=256, n_points=1024, topk=64,
        draws=jax_draws(key, 2, 64 * 64, 1024, 256))
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), N(want[1]), rtol=1e-3,
                               atol=1e-3)


def _moments_f64(hyp, ratio, mean=None, topk=None):
    """An f64 numpy reference of the two moment functions: the covariance
    around ``mean`` (ratios below max - 0.1 zeroed), or the top-k
    weighted mean and covariance."""
    h, r = hyp.astype(np.float64), ratio.astype(np.float64)
    if mean is not None:
        r = np.where(r < r.max(1, keepdims=True) - 0.1, 0.0, r)
        d = h - mean.astype(np.float64)[:, None]
        return (np.einsum('bhk,bhki,bhkj->bkij', r, d, d)
                / (r.sum(1)[..., None, None] + 1e-3),)
    kth = -np.sort(-r, axis=1)[:, topk - 1:topk]
    r = np.where(r >= kth, r, 0.0)
    rs = r.sum(1) + 1e-9
    mu = np.einsum('bhk,bhki->bki', r, h) / rs[..., None]
    d = h - mu[:, None]
    return mu, np.einsum('bhk,bhki,bhkj->bkij', r, d, d) / rs[..., None, None]


# 8 f32 ulps of the largest entry: the covariance entries cancel from
# products near 10^2 (hypotheses about 30 px out, 3 px apart), so an entry
# near 7e-3 carries the rounding of the large terms, and the port's and
# XLA:CPU's summation orders round it differently
MOMENT_ATOL = 8 * float(np.finfo(np.float32).eps)


def test_moments_on_one_cloud():
    """Both packages against an f64 reference: the port no farther from it
    than JAX is, element by element, plus MOMENT_ATOL times the largest
    entry."""
    rng = np.random.default_rng(13)
    hyp = rng.normal(30, 3, (2, 200, 4, 2)).astype(np.float32)
    ratio = rng.random((2, 200, 4)).astype(np.float32)
    mean = rng.normal(30, 1, (2, 4, 2)).astype(np.float32)
    cases = [((tvot.distribution_moments_with_mean(T(hyp), T(ratio),
                                                   T(mean)),),
              (jvot.distribution_moments_with_mean(hyp, ratio, mean),),
              _moments_f64(hyp, ratio, mean)),
             (tvot.distribution_moments(T(hyp), T(ratio), topk=50),
              jvot.distribution_moments(hyp, ratio, topk=50),
              _moments_f64(hyp, ratio, topk=50))]
    for got, want, ref in cases:
        for g, w, r in zip(got, want, ref):
            err_port = np.abs(g.numpy() - r)
            err_jax = np.abs(N(w) - r)
            assert (err_port <= err_jax + MOMENT_ATOL * np.abs(r).max()
                    ).all(), (err_port.max(), err_jax.max())


def _field_to(targets, h, w, unit=True):
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    d = targets[None, None] - np.stack([xs, ys], -1)[:, :, None]
    if unit:
        d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
    return np.ones((1, h, w), np.float32), d[None].astype(np.float32)


def test_voting_variants_on_jax_draws():
    targets = np.array([[5.5, 9.25], [12.0, 3.0]], np.float32)
    mask, off = _field_to(targets, 16, 16, unit=False)
    for m in (mask, 0.5 * mask / mask.sum(), 0.0 * mask):
        np.testing.assert_allclose(
            tvot.motion_voting(T(m), T(off)).numpy(),
            N(jvot.motion_voting(jnp.asarray(m), jnp.asarray(off))),
            atol=1e-4)
    center = np.array([[11.0, 6.0]], np.float32)
    mask, d = _field_to(center, 20, 20)
    key = jax.random.PRNGKey(0)
    want = jvot.ransac_voting_center(jnp.asarray(mask),
                                     jnp.asarray(d[:, :, :, 0]), key,
                                     n_points=256)
    got = tvot.ransac_voting_center(T(mask), T(d[:, :, :, 0]), n_points=256,
                                    draws=jax_draws(key, 1, 400, 256, 128))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), atol=1e-3)
    targets = np.array([[9.0, 13.0]], np.float32)
    mask, d = _field_to(targets, 24, 24)
    par = np.tile(np.array([0.6, 0.8], np.float32), (1, 24, 24, 1, 1))
    for i, field in enumerate((d, par)):
        key = jax.random.PRNGKey(1 + i)
        want = jvot.vanishing_point_voting(jnp.asarray(mask),
                                           jnp.asarray(field), key,
                                           n_points=256)
        got = tvot.vanishing_point_voting(
            T(mask), T(field), n_points=256,
            draws=jax_draws(key, 1, 576, 256, 128))
        np.testing.assert_allclose(got.numpy(), N(want), atol=1e-3)


def test_vertex_field_and_loss():
    rng = np.random.default_rng(14)
    mask = (rng.random((2, 20, 24)) > 0.4).astype(np.float32)
    kps = rng.uniform(-5, 30, (2, 3, 2)).astype(np.float32)
    want = N(jvert.vertex_field(jnp.asarray(mask), jnp.asarray(kps)))
    got = tvert.vertex_field(T(mask), T(kps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    pred = rng.normal(size=want.shape).astype(np.float32)
    np.testing.assert_allclose(
        float(tvert.vertex_loss(T(pred), got, T(mask))),
        float(jvert.vertex_loss(jnp.asarray(pred), jnp.asarray(want),
                                jnp.asarray(mask))), rtol=1e-6)


def test_cov_to_weight_equal():
    rng = np.random.default_rng(15)
    A = rng.normal(size=(3, 9, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(2, dtype=np.float32)
    np.testing.assert_allclose(tpnp.cov_to_weight(T(cov)).numpy(),
                               N(jpnp.cov_to_weight(jnp.asarray(cov))),
                               rtol=1e-5)


def _angle_deg(Ra, Rb):
    """The rotation angle between Ra and Rb in degrees, from the chord
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) in f64 (arccos of the trace
    in f32 cannot resolve 1e-3 degrees)."""
    d = np.linalg.norm((np.asarray(Ra, np.float64)
                        - np.asarray(Rb, np.float64)), axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


def _pnp_problem(seed, b=3, n=9):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    p3 = rng.uniform(-0.05, 0.05, (b, n, 3)).astype(np.float32)
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.03, 0.03, b), rng.uniform(-0.03, 0.03, b),
                  rng.uniform(0.4, 0.6, b)], -1).astype(np.float32)
    K = jcam.LINEMOD_K.astype(np.float32)
    cam = np.einsum('bij,bnj->bni', R, p3) + t[:, None]
    uv = cam[..., :2] / cam[..., 2:] * [K[0, 0], K[1, 1]] + [K[0, 2],
                                                               K[1, 2]]
    uv = (uv + rng.normal(scale=1.0, size=uv.shape)).astype(np.float32)
    A = rng.normal(size=(b, n, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(2, dtype=np.float32)
    return p3, uv, cov, K


def _assert_pose(got, want):
    assert _angle_deg(got[0].numpy(), N(want[0])).max() < 1e-3
    np.testing.assert_allclose(got[1].numpy(), N(want[1]), atol=1e-4)


def test_uncertainty_pnp_on_jax_masks():
    p3, uv, cov, K = _pnp_problem(16)
    key = jax.random.PRNGKey(5)
    masks = jpnp._sample_masks(key, (3,), 9, 32, 6, jnp.ones((3, 9), bool))
    want = jax.jit(jpnp.uncertainty_pnp)(jnp.asarray(p3), jnp.asarray(uv),
                                         jnp.asarray(cov), jnp.asarray(K),
                                         key)
    got = tpnp.uncertainty_pnp(T(p3), T(uv), T(cov), T(K), masks=T(masks))
    _assert_pose(got, want)


def test_solve_pose_and_lm_refine_single_on_jax_masks():
    p3, uv, _, K = _pnp_problem(17)
    conf = np.random.default_rng(17).uniform(0.5, 1.0, (3, 9)).astype(
        np.float32)
    sel = conf > 0.55
    key = jax.random.PRNGKey(6)
    masks = jpnp._sample_masks(key, (3,), 9, 64, 6, jnp.asarray(sel))
    # the default, dual LM (the single-LM refine is tests/
    # test_torch_geometry.py's)
    want = jax.jit(jpnp.solve_pose)(
        jnp.asarray(p3), jnp.asarray(uv), jnp.asarray(conf), jnp.asarray(K),
        key, select_mask=jnp.asarray(sel))
    got = tpnp.solve_pose(T(p3), T(uv), T(conf), T(K), select_mask=T(sel),
                          masks=T(masks))
    _assert_pose(got, want)
    rvec0 = np.array([0.1, -0.2, 0.3], np.float32)
    want = jpnp.lm_refine_single(jnp.asarray(p3[0]), jnp.asarray(uv[0]),
                                 jnp.asarray(conf[0]), jnp.asarray(K),
                                 jnp.asarray(rvec0),
                                 jnp.asarray([0.0, 0.0, 0.5]))
    got = tpnp.lm_refine_single(T(p3[0]), T(uv[0]), T(conf[0]), T(K),
                                T(rvec0), torch.tensor([0.0, 0.0, 0.5]))
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), N(want[1]), atol=1e-4)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3,
                               atol=1e-9)
