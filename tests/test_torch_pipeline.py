"""The whole serving slice: ``infer_poses`` of the port against the JAX
package's, on the same frames, the same r5 weights (f32 in both) and the
same RANSAC hypothesis masks (drawn by JAX, injected into the port).
The port's ``make_jitted_pipeline`` (eager on CPU tensors) gives the same
output as its ``infer_poses``, bit for bit, so JAX's at the same tolerances.

The r5 model's heatmaps on the same crops: rtol 1e-3 / atol 1e-4 and the
same argmax cell for >= 59 of the 60 maps (f32 in both frameworks, where
the point is the algorithm; bf16 rounds at other places in the two).

Tolerances of the poses: the ``selected`` masks equal; rotation angle between the two
results <= 1e-3 rad; translation relative difference <= 1e-3; SPEED
scores within 1e-4.

The frames come from JAX ``make_sample`` at seed 1 (depths 10.0 m and
11.6 m).  At far depth the rotation is weakly observed: on seed 3's
23.0 m frame the JAX solver alone moves 6.9e-4 rad when fed the port's
keypoints (6e-5 px away from its own), which already spends the angle
tolerance, while the solvers given identical inputs agree to 1e-6 (see
``test_torch_geometry.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu import pipeline as jpipe
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.eval import speed_score as jscore
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.ops import crop as jcrop
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu.utils import config as jax_cfg
from esa_pose_estimation_tpu.utils.artifact import load_inference_artifact
from esa_pose_estimation_tpu_torch import pipeline as tpipe
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.eval import speed_score as tscore
from esa_pose_estimation_tpu_torch.ops import crop as tcrop
from esa_pose_estimation_tpu_torch.utils.artifact import load_hrnet_artifact


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARTIFACT = 'artifacts/esa_syn_r5.npz'
N_HYP = 64


def T(a):
    return torch.from_numpy(np.array(a))


def _angle(Ra, Rb):
    c = (np.einsum('bij,bij->b', Ra, Rb) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


@pytest.fixture(scope='module')
def slice_run():
    pts = jsyn.spacecraft_points()
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    s = jax.vmap(lambda k: jsyn.make_sample(k, pts))(keys)
    frames, boxes = np.asarray(s.image), np.asarray(s.bbox)
    variables, _ = load_inference_artifact(ARTIFACT)
    jm = JaxHRNet(jax_cfg.hrnet_esa(), dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(min_keypoints=0, n_hypotheses=N_HYP)
    jout = jpipe.make_jitted_pipeline(jm, pts, **kw)(
        variables, jnp.asarray(frames), jnp.asarray(boxes), key)
    # the hypothesis masks the JAX ransac_epnp drew from the same key
    masks = jpnp._sample_masks(key, (2,), 30, N_HYP, 6, jout.selected)
    model = load_hrnet_artifact(ARTIFACT, dtype=torch.float32, device='cpu')
    tout = tpipe.infer_poses(model, T(frames), T(boxes),
                             tsyn.spacecraft_points(), ransac_masks=T(masks),
                             **kw)
    return s, frames, boxes, model, masks, jax.tree.map(np.asarray, jout), \
        tout, kw


def test_hrnet_esa_r5_forward_f32(slice_run):
    _, frames, boxes, model, _, jout, _, _ = slice_run
    crops, _, _ = jcrop.crop_resize(jnp.asarray(frames), jnp.asarray(boxes),
                                    128)
    x = np.asarray(jcrop.normalize(crops))[..., None]
    with torch.no_grad():
        got = model(T(x))
    assert got.shape == (2, 128, 128, 30) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, jout.heatmaps, rtol=1e-3, atol=1e-4)
    same = (got.reshape(2, -1, 30).argmax(1)
            == jout.heatmaps.reshape(2, -1, 30).argmax(1))
    assert same.sum() >= 59, same.sum()


def test_selection_and_keypoints(slice_run):
    _, _, _, _, _, jout, tout, _ = slice_run
    np.testing.assert_array_equal(tout.selected.numpy(), jout.selected)
    np.testing.assert_array_equal(tout.origins.numpy(), jout.origins)
    np.testing.assert_array_equal(tout.rates.numpy(), jout.rates)
    np.testing.assert_allclose(tout.confidences.numpy(), jout.confidences,
                               atol=1e-4)


def test_pose_agreement(slice_run):
    s, _, _, _, _, jout, tout, _ = slice_run
    assert np.isfinite(tout.R.numpy()).all()
    assert _angle(tout.R.numpy(), jout.R).max() <= 1e-3
    rel = (np.linalg.norm(tout.trans.numpy() - jout.trans, axis=-1)
           / np.linalg.norm(jout.trans, axis=-1))
    assert rel.max() <= 1e-3, rel
    sj = np.asarray(jscore.speed_score_from_matrices(
        jnp.asarray(jout.R), jnp.asarray(jout.trans), s.quat, s.trans).speed)
    st = tscore.speed_score_from_matrices(
        tout.R, tout.trans, T(s.quat), T(s.trans)).speed.numpy()
    np.testing.assert_allclose(st, sj, atol=1e-4, rtol=0)
    assert st.max() < 0.02           # the trained net solves both frames


def test_jitted_pipeline_matches_jax(slice_run):
    """make_jitted_pipeline (eager on CPU tensors) with JAX's masks: the
    same output as infer_poses, so the JAX make_jitted_pipeline's poses at
    test_pose_agreement's tolerances."""
    s, frames, boxes, model, masks, jout, tout, kw = slice_run
    run = tpipe.make_jitted_pipeline(model, tsyn.spacecraft_points(),
                                     ransac_masks=T(masks), **kw)
    got = run(T(frames), T(boxes))
    for name, a, b in zip(got._fields, got, tout):
        assert torch.equal(a, b), name
    assert _angle(got.R.numpy(), jout.R).max() <= 1e-3
    rel = (np.linalg.norm(got.trans.numpy() - jout.trans, axis=-1)
           / np.linalg.norm(jout.trans, axis=-1))
    assert rel.max() <= 1e-3, rel


def test_crop_split_is_exact(slice_run):
    """infer_poses == crop_resize + infer_poses_from_crops, exactly."""
    _, frames, boxes, model, masks, _, tout, kw = slice_run
    crops, rates, origins = tcrop.crop_resize(T(frames), T(boxes), 128)
    tail = tpipe.infer_poses_from_crops(model, crops, rates, origins,
                                        tsyn.spacecraft_points(),
                                        ransac_masks=T(masks), **kw)
    assert torch.equal(tail.quat, tout.quat)
    assert torch.equal(tail.trans, tout.trans)


def test_host_constants_are_copied_once(slice_run, monkeypatch):
    """The serving tail's constants, the EPnP start basis, its control-point
    pair indices and SPEED_K, are made once per (dtype, device) and
    reused; the results are ``torch.equal`` to those of a fresh host copy
    on every call."""
    from esa_pose_estimation_tpu_torch.core import camera
    from esa_pose_estimation_tpu_torch.ops import epnp
    _, frames, boxes, model, masks, _, tout, kw = slice_run
    g = torch.Generator().manual_seed(0)
    B = torch.randn((5, 12, 12), generator=g)
    A = B @ B.transpose(-1, -2)
    cached = epnp.smallest_eigvecs(A)
    basis = epnp._start_basis_tensor(12, 4, A.dtype, A.device)
    assert basis is epnp._start_basis_tensor(12, 4, A.dtype, A.device)
    assert camera.speed_k(torch.float32, torch.device('cpu')) is \
        camera.speed_k(torch.float32, torch.device('cpu'))

    def fresh_basis(m, k, dtype, device):
        return torch.as_tensor(epnp._start_basis(m, k), dtype=dtype,
                               device=device)
    monkeypatch.setattr(epnp, '_start_basis_tensor', fresh_basis)
    dev = torch.device('cpu')
    assert epnp._pair_index(dev)[0] is epnp._pair_index(dev)[0]
    monkeypatch.setattr(epnp, '_pair_index', lambda device: (
        torch.tensor(epnp._PAIR_A), torch.tensor(epnp._PAIR_B)))
    assert torch.equal(epnp.smallest_eigvecs(A), cached)
    crops, rates, origins = tcrop.crop_resize(T(frames), T(boxes), 128)
    fresh = tpipe.infer_poses_from_crops(
        model, crops, rates, origins, tsyn.spacecraft_points(),
        K=torch.as_tensor(camera.SPEED_K, dtype=torch.float32),
        ransac_masks=T(masks), **kw)
    for f in ('quat', 'trans', 'R', 'keypoints_2d'):
        assert torch.equal(getattr(fresh, f), getattr(tout, f)), f


def test_flip_tta_and_no_disambiguation_run(slice_run):
    _, frames, boxes, model, masks, _, _, kw = slice_run
    for extra in (dict(flip_tta=True), dict(disambiguate=False),
                  dict(mirror_evidence='cost'), dict(crop_rule='val')):
        out = tpipe.infer_poses(model, T(frames), T(boxes),
                                tsyn.spacecraft_points(),
                                ransac_masks=T(masks), **kw, **extra)
        assert torch.isfinite(out.trans).all(), extra
    gen = torch.Generator().manual_seed(0)
    out = tpipe.infer_poses(model, T(frames), T(boxes),
                            tsyn.spacecraft_points(), gen)
    assert out.quat.shape == (2, 4) and torch.isfinite(out.quat).all()
    with pytest.raises(ValueError):
        tpipe.infer_poses(model, T(frames), T(boxes),
                          tsyn.spacecraft_points(), crop_rule='bogus')


def test_speed_score_matches():
    rng = np.random.default_rng(0)
    q1, q2 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    t1, t2 = rng.normal(size=(2, 8, 3)).astype(np.float32) + [0, 0, 10]
    want = jscore.speed_score(*(jnp.asarray(a) for a in (q1, t1, q2, t2)))
    got = tscore.speed_score(*(T(a) for a in (q1, t1, q2, t2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_render_frame_matches_jax():
    rng = np.random.default_rng(0)
    kps = rng.uniform(0, 96, size=(30, 2)).astype(np.float32)
    want = np.asarray(jsyn.render_frame(jnp.asarray(kps), 64, 96))
    got = tsyn.render_frame(T(kps), 64, 96).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_make_sample_geometry():
    gen = torch.Generator().manual_seed(0)
    pts = tsyn.spacecraft_points()
    s = tsyn.make_sample(gen, pts, 3, height=120, width=192)
    assert s.image.shape == (3, 120, 192)
    assert ((s.trans[:, 2] >= 5.0) & (s.trans[:, 2] <= 30.0)).all()
    assert (s.quat[:, 0] >= 0).all()
    K = np.asarray(jsyn.scaled_intrinsics(120, 192))
    np.testing.assert_allclose(tsyn.scaled_intrinsics(120, 192).numpy(), K)
    sigmas, amps = jsyn._spot_params(30)
    ts, ta = tsyn._spot_params(30)
    np.testing.assert_allclose(ts.numpy(), np.asarray(sigmas))
    np.testing.assert_allclose(ta.numpy(), np.asarray(amps))
