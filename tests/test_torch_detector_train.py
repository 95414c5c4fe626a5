"""Detector training in the port (``models/detector.detection_loss``,
``train/state.cosine_schedule``, ``cli/train_detector.py`` and the
``--detector-workdir`` route of ``cli/eval_synthetic``) against the JAX
package on the same numpy inputs.

Tolerances:
- ``detection_loss``: relative 1e-6 (the same f32 formula, summed in
  another order);
- ``cosine_schedule``: absolute 1e-7 (optax evaluates the cosine in f32);
- one f32 train step of a width-8 ``TinyDetector`` from the same JAX
  weights on JAX's frames: loss relative 1e-5, each gradient within 1e-4
  of its tensor's norm, the running statistics atol 1e-5, the parameters
  within 2 lr.  Adam's first step moves each element by lr g/(|g| + eps),
  +-lr unless g is near eps (ROADMAP section 3): a gradient near zero that
  the two packages sum to opposite signs moves the two copies 2 lr
  apart;
- frames from JAX's pose draws and their perturbation from JAX's draws:
  atol 1e-4 plus rtol 1e-5 on the [0, 255] scale (sums of thirty f32
  blobs), boxes atol 1e-3 px;
- ``evaluate_detector`` on JAX's frames and the same weights: the mean
  IoU within 1e-4 and the detection rates exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu import pipeline as jpipe
from esa_pose_estimation_tpu.cli import train_detector as jtd
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import detector as jdet
from esa_pose_estimation_tpu_torch.cli import eval_synthetic
from esa_pose_estimation_tpu_torch.cli import train_detector as ttd
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.models import detector as tdet
from esa_pose_estimation_tpu_torch.train.state import cosine_schedule
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    load_detector,
)
from tests.test_torch_detector import _calibrated_variables
from tests.test_torch_train_data import _jax_perturb_draws


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def _jax_frames(seed, b, h, w):
    """JAX's ``make_frame_batch``: (frames, boxes, quat, trans), numpy."""
    pts = jsyn.spacecraft_points()
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    s = jax.jit(jax.vmap(lambda k: jsyn.make_sample(k, pts, height=h,
                                                    width=w)))(keys)
    return tuple(np.asarray(a) for a in (s.image, s.bbox, s.quat, s.trans))


@pytest.mark.parametrize('grid', [(3, 5), (8, 12)])
def test_detection_loss_matches_jax(grid):
    rng = np.random.default_rng(grid[0])
    b, (hs, ws) = 4, grid
    xy = rng.uniform(0, 16 * ws * 0.6, (b, 2)).astype(np.float32)
    wh = rng.uniform(8, 16 * ws * 0.4, (b, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    targets = jdet.detection_targets(jnp.asarray(boxes), (hs, ws), 16)
    out = {'heatmap': rng.normal(-2, 2, (b, hs, ws, 1)),
           'offset': rng.uniform(0, 1, (b, hs, ws, 2)),
           'size': rng.normal(1, 1, (b, hs, ws, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    want = float(jdet.detection_loss({k: jnp.asarray(v)
                                      for k, v in out.items()}, targets))
    got = tdet.detection_loss({k: T(v) for k, v in out.items()},
                              {k: T(v) for k, v in targets.items()})
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize('lr,total', [(1e-3, 800), (1e-3, 7), (0.5, 100),
                                      (1e-3, 0)])
def test_cosine_schedule_matches_optax(lr, total):
    import optax
    want_fn = (optax.cosine_decay_schedule(lr, total, alpha=0.01)
               if total else optax.constant_schedule(lr))
    steps = np.arange(0, total + 5)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps)))
    sched = cosine_schedule(lr, total, alpha=0.01)
    got = np.array([sched(int(i)) for i in steps])
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_grid_is_ceil_of_the_stride():
    """The JAX step renders targets on ceil(in / stride) cells (SAME
    padding); the port's k//2 padding gives the same grid, here on a size
    that is not a multiple of the stride (24 x 40 at stride 16)."""
    assert ttd.grid_hw(24, 40, 16) == (-(-24 // 16), -(-40 // 16)) == (2, 3)
    det = tdet.TinyDetector(width=8).init_weights(
        torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = det(torch.zeros((1, 24, 40, 1)))
    assert tuple(out['heatmap'].shape) == (1, 2, 3, 1)
    model = jdet.TinyDetector(width=8, stride=16)
    out = jax.eval_shape(lambda x: model.init_with_output(
        jax.random.PRNGKey(0), x)[0], jnp.zeros((1, 24, 40, 1)))
    assert out['heatmap'].shape == (1, 2, 3, 1)


def test_make_frame_batch_and_perturb_match_jax():
    """The port's frames from JAX's pose draws, and its perturbation from
    JAX's perturbation draws."""
    frames, boxes, quat, trans = _jax_frames(5, 3, 96, 160)
    got_f, got_b = ttd.make_frame_batch(
        None, 3, tsyn.spacecraft_points(), 96, 160,
        draws={'quat': T(quat), 'trans': T(trans)})
    # thirty f32 exp blobs summed: ulps of values up to 255
    np.testing.assert_allclose(got_f.numpy(), frames, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), boxes, atol=1e-3, rtol=0)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jtd.perturb_frames(key, jnp.asarray(frames)))
    got = ttd.perturb_frames(None, T(frames),
                             draws=_jax_perturb_draws(key, 3, 96, 160))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_train_step_matches_jax():
    h, w, ds = 96, 160, 4
    model = jdet.TinyDetector(width=8, stride=16)
    jstate = jtd.create_detector_state(model, jax.random.PRNGKey(0), LR,
                                       (h // ds, w // ds), total_steps=10)
    variables = jax.tree.map(np.asarray, {
        'params': jstate.params, 'batch_stats': jstate.batch_stats})
    frames, boxes, _, _ = _jax_frames(1, 4, h, w)
    jstate2, jloss = jtd.make_train_step(model, 16, ds)(
        jstate, jnp.asarray(frames), jnp.asarray(boxes))

    @jax.jit
    def jax_grads(params):       # the loss of JAX's make_train_step
        x = jpipe.downsample_frames(jnp.asarray(frames), ds)
        targets = jdet.detection_targets(jnp.asarray(boxes) / ds,
                                         ttd.grid_hw(*x.shape[1:], 16), 16)
        return jax.grad(lambda p: jdet.detection_loss(model.apply(
            {'params': p, 'batch_stats': jstate.batch_stats}, x[..., None],
            train=True, mutable=['batch_stats'])[0], targets))(params)
    jgrads = from_jax_variables({'params': jax.tree.map(
        np.asarray, jax_grads(jstate.params))})

    det = load_detector(variables, width=8, device='cpu')
    st = ttd.create_detector_state(det, LR, total_steps=10)
    metrics = ttd.train_step(st, T(frames), T(boxes), 16, ds)
    assert st.step == 1 and metrics['loss'].dim() == 0
    assert float(metrics['loss']) == pytest.approx(float(jloss), rel=1e-5)
    for n, p in det.named_parameters():
        norm = float(np.linalg.norm(jgrads[n].numpy()))
        assert float((p.grad - jgrads[n]).abs().max()) <= 1e-4 * norm, n
    want = from_jax_variables(jax.tree.map(np.asarray, {
        'params': jstate2.params, 'batch_stats': jstate2.batch_stats}))
    sd = det.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        tol = 1e-5 if 'running' in k else 2 * LR
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=tol,
                                   rtol=1e-5, err_msg=k)
    momenta = {m.BatchNorm_0.momentum for m in det.modules()
               if hasattr(m, 'BatchNorm_0')}
    assert momenta == {0.9}


@pytest.fixture(scope='module')
def calibrated():
    """A width-8 JAX detector whose statistics are those of JAX frames
    (``test_torch_detector``'s helper), computed once."""
    frames0, _, _, _ = _jax_frames(3, 4, 192, 256)
    return _calibrated_variables(8, frames0, 2)


@pytest.mark.parametrize('perturb', [False, True])
def test_evaluate_detector_matches_jax(perturb, calibrated):
    h, w, ds = 192, 256, 2
    model, v = calibrated
    pts = jsyn.spacecraft_points()
    key = jax.random.PRNGKey(9)
    want = jtd.evaluate_detector(model, v, pts, key, 2, 4, h, w, 16, ds,
                                 perturb=perturb)
    batches = []
    for i in range(2):     # JAX's frames for the same keys
        f, gt = jtd.make_frame_batch(jax.random.fold_in(key, i), 4, pts, h,
                                     w)
        if perturb:
            f = jtd.perturb_frames(jax.random.fold_in(key, 5000 + i), f)
        batches.append((T(f), T(gt)))
    got = ttd.evaluate_detector(load_detector(v, width=8, device='cpu'),
                                batches, 16, ds)
    assert got['mean_iou'] == pytest.approx(want['mean_iou'], abs=1e-4)
    assert got['detect_rate_50'] == want['detect_rate_50']
    assert got['detect_rate_75'] == want['detect_rate_75']
    assert 0.0 < want['mean_iou'] < 1.0


def test_cli_train_detector_then_two_stage_eval(tmp_path):
    """A tiny run on the CPU writes the sidecar, the checkpoints and the
    logs, resumes from ``last``, and eval_synthetic serves its
    ``best_iou``; a workdir without one raises."""
    wd = str(tmp_path / 'det')
    argv = ['--workdir', wd, '--device', 'cpu', '--epochs', '2',
            '--steps-per-epoch', '2', '--batch-size', '2', '--height', '96',
            '--width', '160', '--downscale', '2', '--width-ch', '8',
            '--eval-batches', '1', '--augment']
    res = ttd.main(argv)
    assert {'mean_iou', 'detect_rate_50', 'perturbed_mean_iou',
            'perturbed_detect_rate_75'} <= set(res)
    assert tdet.load_detector_config(wd) == {
        'downscale': 2, 'stride': 16, 'width_ch': 8, 'height': 96,
        'width': 160}
    assert {'last', 'best_iou', 'best_scores.json'} <= {
        p.name for p in (tmp_path / 'det' / 'net_detector').iterdir()}
    ttd.main(argv[:5] + ['3'] + argv[6:])          # resumes at epoch 3
    rows = (tmp_path / 'det' / 'log_detector.txt').read_text().split('\n')
    assert rows[0].split('\t')[:4] == ['Epoch', 'LR', 'Train Loss',
                                       'Mean IoU']
    assert [r.split('\t')[0] for r in rows[1:] if r] == ['1', '2', '3']
    with open(tmp_path / 'det' / 'events.jsonl') as f:
        epochs = [json.loads(line) for line in f]
    assert [e['epoch'] for e in epochs] == [1, 2, 3]
    assert all(np.isfinite(e['loss']) for e in epochs)

    common = ['--artifact', 'artifacts/esa_syn_r5.npz', '--device', 'cpu',
              '--frames', '2', '--batch-size', '2', '--n-hypotheses', '8']
    rec = eval_synthetic.main(common + ['--detector-workdir', wd])
    assert rec['frames'] + rec['nonfinite_frames'] == 2
    assert 0 <= rec['detector_fallback_frames'] <= 2
    with pytest.raises(FileNotFoundError, match='best_iou'):
        eval_synthetic.main(common + ['--detector-workdir',
                                      str(tmp_path / 'none')])
