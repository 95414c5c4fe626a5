"""The two-stage slice of the port: NMS (``ops/nms.py``), the detector
(``models/detector.py``) and the detector stages of ``pipeline.py``,
against the JAX package on the same numpy inputs.

Tolerances:
- ``iou_matrix``: 1e-6 (the same f32 formula);
- ``batched_nms``: kept boxes, scores and valid flags exactly equal, ties
  included (both sort stably);
- ``TinyDetector`` maps from the same JAX-initialised weights: atol 1e-4
  (f32 convolutions summed in another order);
- ``detection_targets``: atol 1e-6 (``exp`` may differ by an ulp);
- boxes of ``decode_detections`` and ``detect_frames``: 1e-3 px, scores
  1e-6, valid flags and the full-frame fallback exactly equal;
- ``detect_and_infer`` on the r5 weights (f32 in both) with the JAX
  RANSAC masks injected: the boxes to 1e-3 px, crop origins and rates
  exactly, and the poses at the whole-slice tolerances of
  ``test_torch_pipeline.py`` (1e-3 rad, 1e-3 relative translation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu import pipeline as jpipe
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.models import detector as jdet
from esa_pose_estimation_tpu.ops import nms as jnms
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu.utils import config as jax_cfg
from esa_pose_estimation_tpu.utils.artifact import load_inference_artifact
from esa_pose_estimation_tpu_torch import pipeline as tpipe
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.models import detector as tdet
from esa_pose_estimation_tpu_torch.ops import nms as tnms
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    load_detector,
    load_hrnet_artifact,
)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARTIFACT = 'artifacts/esa_syn_r5.npz'


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_iou_known_values():
    a = np.array([[0.0, 0, 10, 10]], np.float32)
    b = np.array([[0.0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30],
                  [3, 3, 3, 8]], np.float32)
    got = tnms.iou_matrix(T(a), T(b)).numpy()[0]
    np.testing.assert_allclose(got, [1.0, 25 / 175, 0.0, 0.0], atol=1e-6)


def test_iou_random_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (3, 7, 2)).astype(np.float32)
    wh = rng.uniform(-2, 30, (3, 7, 2)).astype(np.float32)   # some empty
    boxes = np.concatenate([xy, xy + wh], -1)
    want = np.asarray(jnms.iou_matrix(jnp.asarray(boxes),
                                      jnp.asarray(boxes[:, :5])))
    got = tnms.iou_matrix(T(boxes), T(boxes[:, :5])).numpy()
    assert got.shape == (3, 7, 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _nms_case(name):
    rng = np.random.default_rng(len(name))
    lead, n = {'random': ((), 24), 'duplicates': ((), 16),
               'ties': ((2,), 20), 'batched': ((2, 3), 12),
               'overflow': ((4,), 5)}[name]
    xy = rng.uniform(0, 60, lead + (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, lead + (n, 2))], -1)
    scores = rng.uniform(0, 1, lead + (n,))
    if name == 'duplicates':
        boxes[..., 8:, :] = boxes[..., :8, :]           # exact copies
        scores[..., 8:] = rng.uniform(0, 1, 8)
    if name == 'ties':
        # three score levels only: every sort sees runs of equal keys,
        # and equal-score overlapping boxes must keep the lower index
        scores = rng.choice([0.3, 0.6, 0.9], lead + (n,))
        boxes[..., 1::2, :] = boxes[..., 0::2, :] + 2.0
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize('max_outputs', [4, 16])
@pytest.mark.parametrize('name', ['random', 'duplicates', 'ties', 'batched',
                                  'overflow'])
def test_batched_nms_exact(name, max_outputs):
    boxes, scores = _nms_case(name)
    kw = dict(iou_threshold=0.3, score_threshold=0.25,
              max_outputs=max_outputs)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = tnms.batched_nms(T(boxes), T(scores), **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any()


def _calibrated_variables(width, frames, downscale, seed=0,
                          heat_bias=-2.0):
    """JAX-initialised detector variables whose BatchNorm statistics are
    those of ``frames`` (40 train-mode passes at momentum 0.9), so every
    map is O(1) as a trained detector's would be; the heatmap bias is set
    so that some images clear the score threshold and some do not."""
    model = jdet.TinyDetector(width=width, stride=16)
    x = jpipe.downsample_frames(jnp.asarray(frames), downscale)[..., None]
    v = model.init(jax.random.PRNGKey(seed), x[:1], train=False)

    @jax.jit
    def step(v):
        _, mut = model.apply(v, x, train=True, mutable=['batch_stats'])
        return {'params': v['params'], 'batch_stats': mut['batch_stats']}
    for _ in range(40):
        v = step(v)
    v = jax.tree.map(lambda a: np.array(a, np.float32), v)
    v['params']['heatmap_head']['bias'][:] = heat_bias
    return model, v


@pytest.fixture(scope='module')
def small_frames():
    """Four 192x256 synthetic frames (the JAX package's), [0, 255]."""
    pts = jsyn.spacecraft_points()
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    s = jax.vmap(lambda k: jsyn.make_sample(k, pts, height=192,
                                            width=256))(keys)
    return np.asarray(s.image), np.asarray(s.bbox)


@pytest.fixture(scope='module')
def calibrated(small_frames):
    """width -> (JAX model, calibrated variables) on ``small_frames``
    pooled by 2, each computed once."""
    cache = {}

    def get(width):
        if width not in cache:
            cache[width] = _calibrated_variables(width, small_frames[0], 2)
        return cache[width]
    return get


@pytest.mark.parametrize('width', [8, 32])
def test_tiny_detector_maps_match(small_frames, calibrated, width):
    frames, _ = small_frames
    model, v = calibrated(width)
    x = np.asarray(jpipe.downsample_frames(jnp.asarray(frames), 2))[..., None]
    want = model.apply(v, jnp.asarray(x), train=False)
    det = load_detector(v, width=width, device='cpu')
    with torch.no_grad():
        got = det(T(x))
    assert set(got) == {'heatmap', 'offset', 'size'}
    for k in got:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape == (4, 6, 8,
                                                        want[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_grid_of_the_serving_geometry():
    """300x480 (1920x1200 pooled by 4): four stride-2 convs give 19x30."""
    det = tdet.TinyDetector(width=8).eval()
    with torch.no_grad():
        out = det(torch.zeros((1, 300, 480, 1)))
    assert out['heatmap'].shape == (1, 19, 30, 1)
    assert out['size'].shape == (1, 19, 30, 2)


def test_init_weights_and_names():
    """The seeded initialisation has the JAX init's statistics, and the
    module tree takes a JAX variable tree leaf for leaf."""
    det = tdet.TinyDetector(width=8)
    det.init_weights(torch.Generator().manual_seed(0))
    sd = det.state_dict()
    assert float(sd['heatmap_head.bias']) == -4.0
    assert float(sd['offset_head.bias'].abs().max()) == 0.0
    assert float(sd['ConvBN_8.BatchNorm_0.weight'].min()) == 1.0
    assert float(sd['ConvBN_8.BatchNorm_0.running_var'].min()) == 1.0
    w = sd['ConvBN_8.Conv_0.weight']
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
    jm = jdet.TinyDetector(width=8, stride=16)
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 64, 64, 1)), train=False),
        jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert set(from_jax_variables(zeros)) == set(sd)
    again = tdet.TinyDetector(width=8).init_weights(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.ConvBN_3.Conv_0.weight,
                       det.ConvBN_3.Conv_0.weight)


def test_detection_targets_match():
    boxes = np.array([[100.0, 80, 300, 240], [10, 12, 40, 31],
                      [0, 0, 479, 299]], np.float32)
    want = jdet.detection_targets(jnp.asarray(boxes), (19, 30), 16)
    got = tdet.detection_targets(T(boxes), (19, 30), 16)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert float(got['center_mask'].sum()) == 3.0


def _logit_maps(tgt):
    t = N(tgt['heatmap'])
    return {'heatmap': np.log(np.maximum(t, 1e-6)
                              / np.maximum(1 - t, 1e-6)).astype(np.float32),
            'offset': N(tgt['offset']).astype(np.float32),
            'size': N(tgt['size']).astype(np.float32)}


def _random_maps(seed, b=3, hs=9, ws=11):
    rng = np.random.default_rng(seed)
    heat = rng.normal(-1.0, 1.5, (b, hs, ws, 1)).astype(np.float32)
    heat[0, 2:4, 2:4] = 2.5                  # a 2x2 plateau of equal peaks
    heat[1] = -12.0                          # nothing clears any threshold
    return {'heatmap': heat,
            'offset': rng.uniform(0, 1, (b, hs, ws, 2)).astype(np.float32),
            'size': rng.normal(0.5, 1.0, (b, hs, ws, 2)).astype(np.float32)}


def _assert_decoded_equal(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize('max_outputs', [1, 8, 40])
def test_decode_detections_random_maps(max_outputs):
    maps = _random_maps(max_outputs)
    kw = dict(top_k=32, score_threshold=0.05, max_outputs=max_outputs)
    want = jdet.decode_detections({k: jnp.asarray(v) for k, v in
                                   maps.items()}, 16, **kw)
    got = tdet.decode_detections({k: T(v) for k, v in maps.items()}, 16,
                                 **kw)
    assert got[0].shape == (3, max_outputs, 4)
    _assert_decoded_equal(got, want)
    assert not got[2][1].any()               # the empty image


def test_decode_target_round_trip():
    boxes = np.array([[100.0, 80, 300, 240], [20, 30, 70, 90]], np.float32)
    maps = _logit_maps(jdet.detection_targets(jnp.asarray(boxes), (20, 20),
                                              16))
    want = jdet.decode_detections({k: jnp.asarray(v) for k, v in
                                   maps.items()}, 16, max_outputs=4)
    got = tdet.decode_detections({k: T(v) for k, v in maps.items()}, 16,
                                 max_outputs=4)
    _assert_decoded_equal(got, want)
    assert got[2][:, 0].all()
    np.testing.assert_allclose(got[0][:, 0].numpy(), boxes, atol=1.0)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_downsample_frames(dtype):
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, (3, 24, 40)).astype(dtype)
    for factor in (1, 2, 4):
        want = np.asarray(jpipe.downsample_frames(jnp.asarray(frames),
                                                  factor))
        got = tpipe.downsample_frames(T(frames), factor)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        if dtype == np.uint8:       # integer sums: exact in f32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


class _JaxPlanted:
    """A detector for the JAX ``detect_frames``: ``apply`` returns fixed
    maps and checks the pooled input's shape."""

    def __init__(self, maps, in_hw):
        self.maps, self.in_hw = maps, in_hw

    def apply(self, variables, x, train=False):
        assert x.shape[1:] == self.in_hw + (1,)
        return {k: jnp.asarray(v) for k, v in self.maps.items()}


class _TorchPlanted(torch.nn.Module):
    def __init__(self, maps, in_hw):
        super().__init__()
        self.maps, self.in_hw = maps, in_hw

    def forward(self, x):
        assert tuple(x.shape[1:]) == self.in_hw + (1,)
        return {k: T(v).to(x.device) for k, v in self.maps.items()}


@pytest.mark.parametrize('box_expand', [1.0, 1.15])
def test_detect_frames_planted_maps(small_frames, box_expand):
    """192x256 frames, downscale 2 (a 6x8 grid): two true boxes, one
    image with no box above the threshold (full-frame fallback) and one
    box past the frame edge (clipped)."""
    frames, boxes = small_frames
    pooled = boxes / 2.0
    pooled[3] = [100.0, 70.0, 140.0, 110.0]          # past 128x96: clipped
    maps = _logit_maps(jdet.detection_targets(jnp.asarray(pooled), (6, 8),
                                              16))
    maps['heatmap'][2] = -10.0                       # no detection
    kw = dict(detector_downscale=2, box_expand=box_expand)
    jb, js = jpipe.detect_frames(_JaxPlanted(maps, (96, 128)), None,
                                 jnp.asarray(frames), **kw)
    tb, ts = tpipe.detect_frames(_TorchPlanted(maps, (96, 128)), T(frames),
                                 **kw)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tb[2].numpy(), [0, 0, 255, 191])
    assert float(tb[3, 2]) == 255.0 and float(tb[3, 3]) == 191.0
    if box_expand == 1.0:
        np.testing.assert_allclose(tb[:2].numpy(), boxes[:2], atol=0.05)


def test_detect_frames_seeded_detector(small_frames, calibrated):
    frames, _ = small_frames
    model, v = calibrated(8)
    jb, js = jpipe.detect_frames(model, v, jnp.asarray(frames),
                                 detector_downscale=2, box_expand=1.15)
    det = load_detector(v, width=8, device='cpu')
    tb, ts = tpipe.detect_frames(det, T(frames), detector_downscale=2,
                                 box_expand=1.15)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    assert (ts.numpy() > 0.05).any()          # some boxes are detections


def _angle(Ra, Rb):
    c = (np.einsum('bij,bij->b', Ra, Rb) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def test_detect_and_infer_r5_with_jax_masks():
    """Two 1920x1200 frames (seed 1: 10.0 m and 11.6 m deep) through a
    planted detector whose maps are the targets of the true boxes on the
    19x30 grid, then the r5 keypoint net (f32) and the solver, the RANSAC
    masks drawn by JAX and injected into the port."""
    pts = jsyn.spacecraft_points()
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    s = jax.vmap(lambda k: jsyn.make_sample(k, pts))(keys)
    frames = np.asarray(s.image)
    maps = _logit_maps(jdet.detection_targets(s.bbox / 4.0, (19, 30), 16))
    variables, _ = load_inference_artifact(ARTIFACT)
    jm = JaxHRNet(jax_cfg.hrnet_esa(), dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(min_keypoints=0, n_hypotheses=16)
    jdet_model = _JaxPlanted(maps, (300, 480))
    jout = jax.jit(lambda v, f, k: jpipe.detect_and_infer(
        jdet_model, None, jm, v, f, pts, k, **kw))(
        variables, jnp.asarray(frames), key)
    jboxes, _ = jpipe.detect_frames(jdet_model, None, jnp.asarray(frames))
    masks = jpnp._sample_masks(key, (2,), 30, 16, 6, jout.selected)

    det = _TorchPlanted(maps, (300, 480))
    model = load_hrnet_artifact(ARTIFACT, dtype=torch.float32, device='cpu')
    tboxes, tscores = tpipe.detect_frames(det, T(frames))
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes), atol=1e-3,
                               rtol=0)
    assert (tscores.numpy() > 0.05).all()             # no fallback
    tout = tpipe.detect_and_infer(det, model, T(frames),
                                  tsyn.spacecraft_points(),
                                  ransac_masks=T(masks), **kw)
    np.testing.assert_array_equal(tout.origins.numpy(),
                                  np.asarray(jout.origins))
    np.testing.assert_array_equal(tout.rates.numpy(), np.asarray(jout.rates))
    np.testing.assert_array_equal(tout.selected.numpy(),
                                  np.asarray(jout.selected))
    assert _angle(tout.R.numpy(), np.asarray(jout.R)).max() <= 1e-3
    jt = np.asarray(jout.trans)
    rel = np.linalg.norm(tout.trans.numpy() - jt, axis=-1) / np.linalg.norm(
        jt, axis=-1)
    assert rel.max() <= 1e-3, rel


def test_detector_config_round_trip(tmp_path):
    cfg = {'downscale': 4, 'stride': 16, 'width_ch': 32, 'height': 1200,
           'width': 1920}
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    jdet.save_detector_config(str(tmp_path / 'j'), **cfg)
    tdet.save_detector_config(str(tmp_path / 't'), **cfg)
    assert ((tmp_path / 't' / 'detector.json').read_bytes()
            == (tmp_path / 'j' / 'detector.json').read_bytes())
    assert tdet.load_detector_config(str(tmp_path / 'j')) == cfg
    assert tdet.load_detector_config(str(tmp_path)) is None


def test_load_detector_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    jm = jdet.TinyDetector(width=8, stride=16)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 32, 32, 1)),
                                         train=False))
    with pytest.raises(RuntimeError, match='cuda'):
        load_detector(v, width=8)
    det = load_detector(v, width=8, device='cpu')
    assert not det.training and det.ConvBN_0.Conv_0.weight.dtype == \
        torch.float32
