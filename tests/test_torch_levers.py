"""The experimental serving levers of the port against the JAX package:
``INT8_SERVING`` (experimental/int8_head.py), ``MERGED_FUSE``
(experimental/merged_fuse.py), ``NHWC_DECODE`` (experimental/nhwc_decode.py)
and the DARK decode (ops/peak.py).

Tolerances:
- int8: quantized activations, weights and the int32 accumulator equal
  JAX's exactly on the same inputs; the int8 forward of ``hrnet_tiny``
  tracks the composite within 0.05 x output scale (JAX's own bound,
  tests/test_models.py:225-226).
- merged: FuseLayer at rtol/atol 2e-5, the whole tiny net at output scale
  rtol 1e-4 / atol 1e-5 (tests/test_models.py:144-185), on JAX's
  randomized parameters and BN statistics, merged against composite and
  port against JAX.
- NHWC: equal integer peaks and maxvals, coordinates within 1e-5.
- DARK: coordinates within 1e-4 px of JAX (f32 blur and log, summed in
  another order), the blurred maps within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.experimental import int8_head as jq
from esa_pose_estimation_tpu.experimental import nhwc_decode as jn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.models import hrnet as jhr
from esa_pose_estimation_tpu.ops import heatmap as jheatmap
from esa_pose_estimation_tpu.ops import peak as jpeak
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.experimental import int8_head as tq
from esa_pose_estimation_tpu_torch.experimental import merged_fuse as tmf
from esa_pose_estimation_tpu_torch.experimental import nhwc_decode as tn
from esa_pose_estimation_tpu_torch.models import hrnet as thr
from esa_pose_estimation_tpu_torch.models import layers as tlayers
from esa_pose_estimation_tpu_torch.ops import peak as tpeak
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils.artifact import from_jax_variables


def T(a):
    return torch.from_numpy(np.array(a))


def _randomized(init_fn, seed, *args):
    """The JAX test's randomization (TestMergedFuse._randomized), drawn
    with numpy: every parameter and BN statistic normal * 0.3, the 1-D
    leaves |.| + 0.5, so the BN fold is not trivial.  The tree's shapes
    come from ``jax.eval_shape``, so nothing is compiled for the init."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(leaf):
        r = rng.normal(size=leaf.shape).astype(np.float32) * 0.3
        return np.abs(r) + 0.5 if leaf.ndim == 1 else r

    return jax.tree.map(draw, shapes)


def _run_jax_merged(fn, merged):
    old = jhr.MERGED_FUSE
    try:
        jhr.MERGED_FUSE = merged
        return fn()
    finally:
        jhr.MERGED_FUSE = old


def _run_port(module, fn, monkeypatch, flag_owner, flag, value):
    monkeypatch.setattr(flag_owner, flag, value)
    with torch.no_grad():
        return fn()


# ----------------------------------------------------------------- merged


def test_fuse_path_specs_address_the_port_children():
    for n in (2, 3, 4):
        layer = thr.FuseLayer(n, tuple(8 * 2 ** i for i in range(n)))
        specs = tmf.fuse_path_specs(n)
        for i, row in enumerate(layer.paths):
            for j, chain in enumerate(row):
                want = [] if i == j else [f'ConvBN_{k}' for k in specs[(i, j)]]
                assert chain == want, (n, i, j)


def test_fuse_layer_merged_matches_composite_and_jax(monkeypatch):
    chans = (8, 16, 32, 64)
    xs = [np.asarray(jax.random.normal(jax.random.PRNGKey(10 + i),
                                       (2, 32 // 2 ** i, 32 // 2 ** i,
                                        chans[i]))) for i in range(4)]
    jlayer = jhr.FuseLayer(4, chans)
    jxs = [jnp.asarray(x) for x in xs]
    variables = _randomized(lambda k, a: jlayer.init(k, a, train=False), 1,
                            jxs)
    # MERGED_FUSE is read while tracing: jit inside the switch
    jmerged = _run_jax_merged(lambda: jax.jit(lambda v, a: jlayer.apply(
        v, a, train=False))(variables, jxs), True)
    layer = thr.FuseLayer(4, chans).eval()
    layer.load_state_dict(from_jax_variables(variables), strict=True)
    txs = [T(x.transpose(0, 3, 1, 2)) for x in xs]
    ref = _run_port(layer, lambda: layer(txs), monkeypatch, thr,
                    'MERGED_FUSE', False)
    got = _run_port(layer, lambda: layer(txs), monkeypatch, thr,
                    'MERGED_FUSE', True)
    for i in range(4):
        g = got[i].numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, ref[i].numpy().transpose(0, 2, 3, 1),
                                   rtol=2e-5, atol=2e-5, err_msg=str(i))
        np.testing.assert_allclose(g, np.asarray(jmerged[i]), rtol=2e-5,
                                   atol=2e-5, err_msg=str(i))


@pytest.fixture(scope='module')
def tiny_randomized():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 64, 64, 1)))
    jm = JaxHRNet(jcfg.hrnet_tiny())
    variables = _randomized(lambda k, a: jm.init(k, a, train=False), 3,
                            jnp.asarray(x))
    jmerged = np.asarray(_run_jax_merged(lambda: jax.jit(
        lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x)),
        True))
    model = thr.HRNet(tcfg.hrnet_tiny()).eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return x, model, jmerged


def test_full_tiny_net_merged_matches_composite_and_jax(tiny_randomized,
                                                        monkeypatch):
    x, model, jmerged = tiny_randomized
    ref = _run_port(model, lambda: model(T(x)), monkeypatch, thr,
                    'MERGED_FUSE', False).numpy()
    got = _run_port(model, lambda: model(T(x)), monkeypatch, thr,
                    'MERGED_FUSE', True).numpy()
    # randomized BN statistics blow activations up through the net:
    # compare at the output's own scale, as the JAX test does
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got / scale, jmerged / scale, rtol=1e-4,
                               atol=1e-5)


def test_train_mode_never_merges(tiny_randomized, monkeypatch):
    _, model, _ = tiny_randomized

    def refuse(*a, **k):
        raise AssertionError('merged fuse in training mode')

    monkeypatch.setattr(thr, 'merged_fuse', refuse)
    monkeypatch.setattr(thr, 'MERGED_FUSE', True)
    model.train()
    try:
        with torch.no_grad():
            out = model(torch.zeros((1, 64, 64, 1)))
    finally:
        model.eval()
    assert out.shape == (1, 64, 64, 6)


# ------------------------------------------------------------------- int8


def test_int8_quantizers_and_accumulator_equal_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 12, 10, 24))
         * rng.uniform(0.1, 4.0, size=(3, 1, 1, 1))).astype(np.float32)
    w = (0.05 * rng.normal(size=(3, 3, 24, 40))).astype(np.float32)
    jwq, jsw = jq.quantize_weights_per_channel(jnp.asarray(w))
    twq, tsw = tq.quantize_weights_per_channel(T(w))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    jxq, jsx = jq.quantize_activations(jnp.asarray(x))
    txq, tsx = tq.quantize_activations(T(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    for stride in (1, 2):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ('NHWC', 'HWIO', 'NHWC'))
        want = jax.lax.conv_general_dilated(
            jxq, jwq, (stride, stride), 'SAME', dimension_numbers=dn,
            preferred_element_type=jnp.int32)
        got = tq.int8_conv_acc(txq, twq, stride)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tq.int8_conv(T(x), twq, tsw, stride).numpy(),
            np.asarray(jq.int8_conv(jnp.asarray(x), jwq, jsw, stride=stride)))


@pytest.mark.parametrize('mkn', [(3, 5, 7), (20, 16, 8), (1, 9, 1)])
def test_int8_product_pads_ragged_shapes_exactly(mkn):
    """The card's _int_mm wants M > 16 and K, N multiples of 8: the padded
    product equals the exact integer product at any shape."""
    m, k, n = mkn
    rng = np.random.default_rng(m * k * n)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    got = tq._mm_i32(T(a), T(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_round_half_to_even_like_jnp():
    x = np.array([[[[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]]]], np.float32)
    # max-abs 127 gives scale 1: the halves are rounded as they stand
    np.testing.assert_array_equal(
        tq.quantize_activations(T(x))[0].numpy(),
        np.asarray(jq.quantize_activations(jnp.asarray(x))[0]))


def test_head_error_stats_reasonable():
    gen = torch.Generator().manual_seed(2)
    w = 0.05 * torch.randn((3, 3, 16, 16), generator=gen)
    stats = tq.head_error_stats(gen, w, batch=2, hw=16)
    assert stats['rel_err_mean'] < 0.2
    assert stats['abs_err_p99'] < stats['ref_abs_p99']


@pytest.fixture(scope='module')
def tiny_bf16():
    """The port's hrnet_tiny in bf16 with PyTorch's default init, seeded
    (the int8 checks hold the port to itself)."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = thr.HRNet(tcfg.hrnet_tiny(), dtype=torch.bfloat16)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    return model.eval(), T(x)


def test_int8_forward_tracks_composite(tiny_bf16, monkeypatch):
    model, x = tiny_bf16
    assert model.ConvBN_1.int8_serving and not model.ConvBN_2.int8_serving
    calls = []
    real = tlayers.int8_conv
    monkeypatch.setattr(tlayers, 'int8_conv',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ref = _run_port(model, lambda: model(x), monkeypatch, tlayers,
                    'INT8_SERVING', False).numpy()
    assert not calls
    out = _run_port(model, lambda: model(x), monkeypatch, tlayers,
                    'INT8_SERVING', True).numpy()
    assert calls == [1]                      # the head conv only
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out - ref).max()) < 0.05 * scale
    assert float(np.abs(out - ref).max()) > 0  # the int8 path ran


def test_int8_train_mode_never_quantizes(tiny_bf16, monkeypatch):
    model, x = tiny_bf16

    def refuse(*a, **k):
        raise AssertionError('int8 in training mode')

    monkeypatch.setattr(tlayers, 'int8_conv', refuse)
    monkeypatch.setattr(tlayers, 'INT8_SERVING', True)
    model.train()
    try:
        with torch.no_grad():
            out = model(x)
    finally:
        model.eval()
    assert out.shape == (2, 32, 32, 6) and torch.isfinite(out).all()


# ------------------------------------------------------------ NHWC decode


@pytest.mark.parametrize('kind', ['gaussian', 'noise'])
def test_nhwc_decode_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == 'noise':
        hm = rng.uniform(size=(2, 32, 32, 6)).astype(np.float32)
    else:
        kps = rng.uniform(4, 28, size=(12, 2)).astype(np.float32)
        hm = np.asarray(jheatmap.render_heatmaps(jnp.asarray(kps), 32, 32,
                                                 2.0)).reshape(2, 6, 32, 32)
        hm = np.ascontiguousarray(hm.transpose(0, 2, 3, 1))
    jc, jm = jn.decode_heatmaps_nhwc(jnp.asarray(hm))
    jpk, _ = jn.argmax_peaks_nhwc(jnp.asarray(hm))
    tc, tm = tn.decode_heatmaps_nhwc(T(hm))
    tpk, _ = tn.argmax_peaks_nhwc(T(hm))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


def test_nhwc_decode_flag_dispatch(monkeypatch):
    hm = T(np.random.default_rng(4).uniform(size=(2, 16, 16, 5)
                                            ).astype(np.float32))
    monkeypatch.setattr(tpeak, 'NHWC_DECODE', False)
    c0, m0 = tpeak.decode_heatmaps_auto_nhwc(hm)
    monkeypatch.setattr(tpeak, 'NHWC_DECODE', True)
    c1, m1 = tpeak.decode_heatmaps_auto_nhwc(hm)
    assert torch.equal(m0, m1)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), atol=1e-5, rtol=0)
    c2, _ = tn.decode_heatmaps_nhwc(hm)
    assert torch.equal(c1, c2)


# ------------------------------------------------------------------- DARK


def _dark_maps(seed, n=4):
    rng = np.random.default_rng(seed)
    kps = rng.uniform(8, 56, size=(n, 2))
    hm = np.asarray(jheatmap.render_heatmaps(
        jnp.asarray(kps, jnp.float32), 64, 64, 2.0), np.float64)
    return np.clip(hm + rng.normal(scale=0.01, size=hm.shape), 0, 1
                   ).astype(np.float32)


@pytest.mark.parametrize('seed', [1, 2])
def test_dark_decode_matches_jax(seed):
    hm = _dark_maps(seed)
    jc, jm = jpeak.decode_heatmaps_dark(jnp.asarray(hm))
    tc, tm = tpeak.decode_heatmaps_dark(T(hm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        tpeak.gaussian_modulate(T(hm)).numpy(),
        np.asarray(jpeak.gaussian_modulate(jnp.asarray(hm))), atol=1e-6,
        rtol=0)


def test_dark_recovers_subpixel():
    kps = np.array([[30.42, 21.77]], np.float32)
    hm = np.asarray(jheatmap.render_heatmaps(jnp.asarray(kps), 64, 64, 2.0))
    coords, _ = tpeak.decode_heatmaps_dark(T(hm))
    np.testing.assert_allclose(coords[0].numpy(), kps[0], atol=0.12)
