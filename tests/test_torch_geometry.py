"""Port geometry against the JAX package: camera helpers, fixed-iteration
linear algebra, EPnP, RANSAC-EPnP (with the JAX hypothesis masks injected)
and the (dual) LM refinement.

Tolerance: f32 atol/rtol 1e-5 unless a test states otherwise.  Both
packages run the same fixed-iteration f32 algorithms; what differs is
summation order inside reductions and products.  Where an algorithm is
ill-conditioned in f32 (closed-form 3x3 eigenvectors near a tie, EPnP's
4-step inverse iteration), both packages sit a measured distance from the
same algorithm run in f64, and the test states that distance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from esa_pose_estimation_tpu.core import camera as jcam
from esa_pose_estimation_tpu.core import linalg as jlin
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.ops import epnp as jepnp
from esa_pose_estimation_tpu.ops import heatmap as jheatmap
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu_torch.core import camera as tcam
from esa_pose_estimation_tpu_torch.core import linalg as tlin
from esa_pose_estimation_tpu_torch.ops import epnp as tepnp
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
SPEED_K = np.asarray(jcam.SPEED_K, np.float32)
LINEMOD_K = np.asarray(jcam.LINEMOD_K, np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def close(jax_val, torch_val, **kw):
    np.testing.assert_allclose(torch_val.numpy(), np.asarray(jax_val),
                               **(kw or TOL))


def problem(seed, batch, n=30, noise_px=0.0, depth=10.0):
    """(batch, n, 3) model points and their (batch, n, 2) SPEED-camera
    projections under random poses, with optional pixel noise."""
    rng = np.random.default_rng(seed)
    p3 = rng.uniform(-0.5, 0.5, size=(batch, n, 3))
    R = Rot.random(batch, random_state=rng).as_matrix()
    t = np.stack([rng.uniform(-1, 1, batch), rng.uniform(-1, 1, batch),
                  depth + rng.uniform(-2, 2, batch)], -1)
    cam = np.einsum('bij,bnj->bni', R, p3) + t[:, None, :]
    uv = cam[..., :2] / cam[..., 2:3] * SPEED_K[[0, 1], [0, 1]] \
        + SPEED_K[[0, 1], [2, 2]]
    uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    return p3.astype(np.float32), uv.astype(np.float32)


# --------------------------------------------------------------- camera


def test_camera_helpers():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    close(jcam.quat_to_rotmat(jnp.asarray(q)), tcam.quat_to_rotmat(T(q)))
    R = np.asarray(jcam.quat_to_rotmat(jnp.asarray(q)))
    close(jcam.rotmat_to_quat(jnp.asarray(R)), tcam.rotmat_to_quat(T(R)))
    rv = rng.normal(size=(64, 3)).astype(np.float32)
    rv[:4] *= 1e-9                                   # the theta -> 0 branch
    close(jcam.rodrigues(jnp.asarray(rv)), tcam.rodrigues(T(rv)))
    close(jcam.rotmat_to_rvec(jnp.asarray(R)), tcam.rotmat_to_rvec(T(R)))
    p3 = problem(1, 1)[0][0]
    t = np.array([0.1, -0.2, 9.0], np.float32)
    close(jcam.project_points(jnp.asarray(p3), jnp.asarray(R[0]),
                              jnp.asarray(t), jnp.asarray(SPEED_K)),
          tcam.project_points(T(p3), T(R[0]), T(t), T(SPEED_K)))


# ---------------------------------------------------------------- linalg


@pytest.mark.parametrize('n', [4, 6, 12])
def test_cholesky_and_solves(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(32, n, n))
    A = (M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(32, n, 3)).astype(np.float32)
    L = jlin.cholesky_small(jnp.asarray(A))
    close(L, tlin.cholesky_small(T(A)))
    close(jlin.cho_solve_small(L, jnp.asarray(b)),
          tlin.cho_solve_small(T(L), T(b)), rtol=1e-4, atol=1e-5)
    close(jlin.solve_psd(jnp.asarray(A), jnp.asarray(b[..., 0])),
          tlin.solve_psd(T(A), T(b[..., 0])), rtol=1e-4, atol=1e-5)


def test_singular_cholesky_stays_finite():
    A = np.zeros((2, 6, 6), np.float32)
    L = tlin.cholesky_small(T(A))
    assert torch.isfinite(L).all()
    close(jlin.cholesky_small(jnp.asarray(A)), L)


def test_solve3_cramer():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(16, 3, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3, 5)).astype(np.float32)
    close(jlin._solve3_cramer(jnp.asarray(a), jnp.asarray(b)),
          tlin._solve3_cramer(T(a), T(b)), rtol=1e-4, atol=1e-5)


def test_eigen3_generic_spectra():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(200, 3, 3))
    A = (M @ np.swapaxes(M, -1, -2)).astype(np.float32)
    for j, t in zip(jlin.eigvals3_sym(jnp.asarray(A)),
                    tlin.eigvals3_sym(T(A))):
        close(j, t, rtol=1e-5, atol=1e-4)
    vj = np.asarray(jlin.smallest_eigvec3(jnp.asarray(A)))
    vt = tlin.smallest_eigvec3(T(A)).numpy()
    # same algorithm: the same vector, sign included, where the smallest
    # eigenvalue is well separated
    w = np.linalg.eigvalsh(A.astype(np.float64))
    sep = (w[:, 1] - w[:, 0]) > 1e-2 * w[:, 2]
    np.testing.assert_allclose(vt[sep], vj[sep], rtol=1e-4, atol=1e-4)


def test_eigen3_ties_isotropic_zero():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(50, 3, 3))
    A = M @ np.swapaxes(M, -1, -2)
    w, V = np.linalg.eigh(A)
    w[:, 1] = w[:, 0]                            # exactly repeated smallest
    A = np.einsum('nij,nj,nkj->nik', V, w, V)
    cases = [A, np.broadcast_to(2.5 * np.eye(3), (4, 3, 3)),
             np.zeros((2, 3, 3)), np.broadcast_to(-4.0 * np.eye(3),
                                                  (2, 3, 3))]
    for i, A64 in enumerate(cases):
        A32 = np.ascontiguousarray(A64, np.float32)
        if i > 0:
            # isotropic and zero inputs: exact eigenvalues, no NaN
            lo = np.stack([x.numpy() for x in tlin.eigvals3_sym(T(A32))], -1)
            np.testing.assert_allclose(lo, np.linalg.eigvalsh(A64),
                                       atol=1e-5)
        v = tlin.smallest_eigvec3(T(A32)).numpy()
        assert np.isfinite(v).all()
        np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0,
                                   atol=1e-5)
        ray = np.einsum('...i,...ij,...j->...', v, A64, v)
        ev = np.linalg.eigvalsh(A64)
        scale = np.maximum(np.abs(ev).max(-1), 1e-30)
        np.testing.assert_array_less((ray - ev[..., 0]) / scale, 1e-4)


# ------------------------------------------------------------------ EPnP


def test_polar_rotation_and_kabsch():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A[::2] *= -1                                 # det<0 half: Kabsch fix
    Rj = np.asarray(jepnp.polar_rotation(jnp.asarray(A)))
    Rt = tepnp.polar_rotation(T(A)).numpy()
    # the nearest rotation is itself ill-conditioned where the two smallest
    # singular values nearly tie: compare elementwise where they are apart,
    # and by the Procrustes objective tr(R^T A) everywhere.  The det<0
    # reflection axis comes from the closed-form f32 eigenvector of A^T A,
    # whose error is ~eps * lmax / gap: up to 3.9e-5 on this batch in the
    # port and 4.6e-6 in JAX against an f64 SVD (the port in f64: 2e-15).
    s = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    apart = ((s[:, 1] - s[:, 2]) > 0.05 * s[:, 0]) & (s[:, 2] > 0.1 * s[:, 0])
    assert apart.sum() >= 16
    np.testing.assert_allclose(Rt[apart], Rj[apart], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.einsum('bij,bij->b', Rt, A),
                               np.einsum('bij,bij->b', Rj, A), **TOL)
    src = rng.normal(size=(4, 20, 3)).astype(np.float32)
    R = Rot.random(4, random_state=rng).as_matrix().astype(np.float32)
    dst = np.einsum('bij,bnj->bni', R, src) + 0.3
    w = rng.uniform(0.2, 1.0, size=(4, 20)).astype(np.float32)
    for j, t in zip(jepnp.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(w)),
                    tepnp.weighted_kabsch(T(src), T(dst), T(w))):
        close(j, t)


def test_epnp_on_fixture_and_masks():
    ref = np.load('tests/fixtures/pnp_fixture.npz')
    p3 = ref['p3d'].astype(np.float32)
    p2 = ref['p2d'].astype(np.float32)
    sj = jepnp.epnp_precompute(jnp.asarray(p3), jnp.asarray(p2),
                               jnp.asarray(LINEMOD_K))
    st = tepnp.epnp_precompute(T(p3), T(p2), T(LINEMOD_K))
    for j, t in zip(sj, st):
        close(j, t)
    w = np.ones(len(p3), np.float32)
    w[::5] = 0.0
    # with the beta refinement each package lands within 1e-5 of the same
    # algorithm in f64 (measured 1.6e-6 JAX, 8.2e-6 port on R): 3e-5 apart
    jfit = jax.jit(jepnp.epnp_from_mask, static_argnums=2)
    for j, t in zip(jfit(sj, jnp.asarray(w), True),
                    tepnp.epnp_from_mask(st, T(w))):
        close(j, t, rtol=1e-4, atol=3e-5)
    # Without the beta refinement (closed-form beta1, the RANSAC
    # hypothesis path) this fixture is ill-conditioned in f32: both
    # packages land ~1e-4 from the same algorithm run in f64 (measured
    # 1.0e-4 JAX, 4.6e-5 port on R), so the two agree to 3e-4 here.
    for j, t in zip(jfit(sj, jnp.asarray(w), False),
                    tepnp.epnp_from_mask(st, T(w), False)):
        close(j, t, rtol=3e-4, atol=3e-4)


def _far6():
    return (np.load('tests/fixtures/far6_p3.npy'),
            np.load('tests/fixtures/far6_uncropped.npy'),
            np.load('tests/fixtures/far6_sel.npy'))


def test_ransac_far_depth_six_points_with_jax_masks():
    p3, p2, sel = _far6()
    key = jax.random.PRNGKey(0)
    batch, n = p3.shape[:-2], p3.shape[-2]
    masks = jpnp._sample_masks(key, batch, n, 64, 6, jnp.asarray(sel))
    rj = jpnp.ransac_epnp(jnp.asarray(p3), jnp.asarray(p2),
                          jnp.asarray(SPEED_K), key, valid=jnp.asarray(sel),
                          n_hypotheses=64, sample_size=6, lm_iters=10)
    rt = tpnp.ransac_epnp(T(p3), T(p2), T(SPEED_K), valid=T(sel),
                          n_hypotheses=64, sample_size=6, lm_iters=10,
                          masks=T(masks))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    close(rj.R, rt.R)
    close(rj.t, rt.t, rtol=1e-5, atol=1e-4)
    assert abs(float(rt.t[..., 2].reshape(-1)[0]) - 25.69) < 1.0


def test_ransac_rejects_outliers_with_jax_masks():
    p3, p2 = problem(7, 3, noise_px=0.5)
    p2[:, [1, 8, 15]] += np.array([150.0, -90.0], np.float32)
    key = jax.random.PRNGKey(2)
    valid = np.ones((3, 30), bool)
    masks = jpnp._sample_masks(key, (3,), 30, 32, 6, jnp.asarray(valid))
    rj = jpnp.ransac_epnp(jnp.asarray(p3), jnp.asarray(p2),
                          jnp.asarray(SPEED_K), key, n_hypotheses=32)
    rt = tpnp.ransac_epnp(T(p3), T(p2), T(SPEED_K), n_hypotheses=32,
                          masks=T(masks))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert not rt.inliers[:, [1, 8, 15]].any()
    close(rj.R, rt.R)
    close(rj.t, rt.t)


def test_sampled_masks_draw_distinct_valid_points():
    valid = torch.ones((4, 30), dtype=torch.bool)
    valid[:, :10] = False
    gen = torch.Generator().manual_seed(0)
    m = tpnp._sample_masks(gen, (4,), 30, 16, 6, valid)
    assert m.shape == (4, 16, 30)
    assert (m.sum(-1) == 6).all()
    assert (m[:, :, :10] == 0).all()


# -------------------------------------------------------------------- LM


def test_lm_refine_from_perturbed_init():
    p3, p2 = problem(5, 4, noise_px=0.3)
    rng = np.random.default_rng(0)
    # start near the truth: an EPnP solve, perturbed
    Rs, ts = tepnp.epnp_from_mask(
        tepnp.epnp_precompute(T(p3), T(p2), T(SPEED_K)),
        torch.ones((4, 30)))
    dR = Rot.from_rotvec(rng.normal(scale=0.05, size=(4, 3))).as_matrix()
    R0 = np.einsum('bij,bjk->bik', dR, Rs.numpy()).astype(np.float32)
    t0 = ts.numpy() + np.array([0.2, -0.1, 0.4], np.float32)
    w = rng.uniform(0.5, 1.0, size=(4, 30)).astype(np.float32)
    args_j = [jnp.asarray(a) for a in (p3, p2, w, SPEED_K, R0, t0)]
    args_t = [T(a) for a in (p3, p2, w, SPEED_K, R0, t0)]
    Rj, tj, cj = jpnp._lm_refine_batched(*args_j, iters=10)
    Rt, tt, ct = tpnp._lm_refine_batched(*args_t, iters=10)
    close(Rj, Rt)
    close(tj, tt)
    close(cj, ct, rtol=1e-4, atol=1e-9)


def _mirror_case():
    d = np.load('tests/fixtures/mirror_flip.npz')
    p3 = np.asarray(jsyn.spacecraft_points(30))
    return p3, d['p2'], d['sel'], d['conf'], d['Rgt'], d['tgt']


def test_mirror_pose_and_dual_refine():
    p3, p2, sel, conf, Rgt, tgt = _mirror_case()
    w = np.where(sel, conf, 0.0).astype(np.float32)
    Rm_j, tm_j = jpnp.mirror_pose(jnp.asarray(p3), jnp.asarray(Rgt),
                                  jnp.asarray(tgt), jnp.asarray(w))
    Rm_t, tm_t = tpnp.mirror_pose(T(p3), T(Rgt), T(tgt), T(w))
    close(Rm_j, Rm_t)
    close(tm_j, tm_t)
    Rj, tj = jpnp.lm_refine_dual(jnp.asarray(p3), jnp.asarray(p2),
                                 jnp.asarray(w), jnp.asarray(SPEED_K),
                                 Rm_j, tm_j, iters=10)
    Rt, tt = tpnp.lm_refine_dual(T(p3), T(p2), T(w), T(SPEED_K), T(Rm_j),
                                 T(tm_j), iters=10)
    close(Rj, Rt)
    close(tj, tt)


def test_heatmap_evidence_and_dual_pick():
    p3, p2, sel, conf, Rgt, tgt = _mirror_case()
    p3, p2, sel = p3[None], p2[None], sel[None]
    Rgt, tgt = Rgt[None].astype(np.float32), tgt[None].astype(np.float32)
    lo = np.floor(p2.min(axis=1) - 8.0)
    span = (p2.max(axis=1) - p2.min(axis=1)).max(axis=-1) + 16.0
    origins = lo.astype(np.int32)
    rates = (128.0 / span).astype(np.float32)
    kp_crop = (p2 - origins[:, None, :]) * rates[:, None, None]
    hm = np.transpose(np.asarray(jheatmap.render_heatmaps(
        jnp.asarray(kp_crop), 128, 128, 2.0)), (0, 2, 3, 1))
    w = sel.astype(np.float32)
    Rm, tm = jpnp.mirror_pose(jnp.asarray(p3), jnp.asarray(Rgt),
                              jnp.asarray(tgt), jnp.asarray(w))
    Rs, ts = np.stack([Rgt, np.asarray(Rm)]), np.stack([tgt, np.asarray(tm)])
    fj = jpnp.heatmap_evidence(jnp.asarray(hm), jnp.asarray(p3),
                               jnp.asarray(SPEED_K), jnp.asarray(rates),
                               jnp.asarray(origins), valid=jnp.asarray(sel))
    ft = tpnp.heatmap_evidence(T(hm), T(p3), T(SPEED_K), T(rates),
                               T(origins), valid=T(sel))
    close(fj(jnp.asarray(Rs), jnp.asarray(ts)), ft(T(Rs), T(ts)))
    Rj, tj = jpnp.lm_refine_dual(jnp.asarray(p3), jnp.asarray(p2),
                                 jnp.asarray(w), jnp.asarray(SPEED_K), Rm,
                                 tm, iters=10, evidence_fn=fj)
    Rt, tt = tpnp.lm_refine_dual(T(p3), T(p2), T(w), T(SPEED_K), T(Rm),
                                 T(tm), iters=10, evidence_fn=ft)
    close(Rj, Rt)
    close(tj, tt)
