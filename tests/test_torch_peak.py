"""Peak decode of the port (``ops/peak.py``, the plain version of the CUDA
kernel ``csrc/peak_decode.cu``) against the JAX decode and the TPU kernel
run in the Pallas interpreter.

Also an emulation of the kernel's band split and tie rule against
``argmax_peaks``, and the DARK decode against the JAX one.

Tolerance: integer peaks and maxvals bitwise equal; coords atol 1e-5 (the
log and the stencil are the same f32 operations; only ``log``'s last bit
may differ between the two libraries).  DARK: coordinates within 1e-4 px
of JAX (f32 blur and log, summed in another order), the blurred maps
within 1e-6.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.ops import heatmap, peak
from esa_pose_estimation_tpu.ops.pallas import decode_heatmaps_pallas
from esa_pose_estimation_tpu_torch.ops import peak as tpeak
from esa_pose_estimation_tpu_torch.ops.kernels import peak_decode as k1_mod
from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
    launch_shape,
    peak_decode,
)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaussians():
    rng = np.random.default_rng(0)
    kps = rng.uniform(6, 120, size=(3, 5, 2)).astype(np.float32)
    return np.asarray(heatmap.render_heatmaps(jnp.asarray(kps), 128, 128,
                                              2.0))


def _noise():
    rng = np.random.default_rng(1)
    return rng.uniform(size=(4, 3, 64, 64)).astype(np.float32)


def _border():
    hm = np.full((1, 8, 8), 1e-3, np.float32)
    hm[0, 0, 1] = 1.0
    return hm


def _ties():
    # repeated maxima: the first row-major occurrence must win
    hm = np.zeros((2, 16, 16), np.float32)
    hm[0, 5, 9] = hm[0, 5, 3] = hm[0, 9, 1] = 0.7
    hm[1, 12, 2] = hm[1, 3, 14] = 0.9
    return hm


CASES = {'gaussians': _gaussians, 'noise': _noise, 'border': _border,
         'ties': _ties}


def _check(c_t, m_t, c_ref, m_ref):
    c_t, m_t = c_t.numpy(), m_t.numpy()
    np.testing.assert_array_equal(m_t, np.asarray(m_ref))
    np.testing.assert_allclose(c_t, np.asarray(c_ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_decode_matches_jax(case):
    hm = CASES[case]()
    c_ref, m_ref = peak.decode_heatmaps(jnp.asarray(hm))
    c_t, m_t = tpeak.decode_heatmaps(torch.from_numpy(hm))
    _check(c_t, m_t, c_ref, m_ref)
    # integer peaks equal
    ij, _ = peak.argmax_peaks(jnp.asarray(hm))
    it, _ = tpeak.argmax_peaks(torch.from_numpy(hm))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_decode_matches_tpu_kernel_interpreted(case):
    hm = CASES[case]()
    c_ref, m_ref = decode_heatmaps_pallas(jnp.asarray(hm), interpret=True)
    c_t, m_t = tpeak.decode_heatmaps(torch.from_numpy(hm))
    _check(c_t, m_t, c_ref, m_ref)


def _rendered():
    rng = np.random.default_rng(2)
    kps = rng.uniform(4, 60, size=(2, 7, 2)).astype(np.float32)
    nchw = np.asarray(heatmap.render_heatmaps(jnp.asarray(kps), 64, 64, 2.0))
    return nchw + rng.uniform(0, 1e-3, nchw.shape).astype(np.float32)


# the serving entry point's cases: (B, K, H, W) maps, or (K, H, W) ones
# as one image, transposed to the network's (B, H, W, K) output
NHWC_CASES = {'rendered': _rendered, **CASES}


@pytest.mark.parametrize('case', sorted(NHWC_CASES))
def test_channels_last_decode_matches_jax_nhwc_path(case):
    hm = NHWC_CASES[case]()
    nchw = hm if hm.ndim == 4 else hm[None]
    nhwc = np.ascontiguousarray(nchw.transpose(0, 2, 3, 1))
    c_ref, m_ref = peak.decode_heatmaps_auto_nhwc(jnp.asarray(nhwc))
    c_t, m_t = tpeak.decode_heatmaps_auto_nhwc(torch.from_numpy(nhwc))
    assert c_t.shape == nchw.shape[:2] + (2,)
    assert m_t.shape == nchw.shape[:2]
    _check(c_t, m_t, c_ref, m_ref)
    # the (..., H, W) entry point takes the same route
    c_a, m_a = tpeak.decode_heatmaps_auto(torch.from_numpy(nchw))
    _check(c_a, m_a, c_ref, m_ref)


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing():
    hm = torch.from_numpy(_noise()[0]).permute(1, 2, 0)[None]   # (1,H,W,K)
    before = peak_decode.launches
    c, m = peak_decode(hm)
    assert peak_decode.launches == before
    c_p, m_p = tpeak.decode_heatmaps(hm.permute(0, 3, 1, 2))
    assert torch.equal(c, c_p) and torch.equal(m, m_p)
    _, _, idx = peak_decode(hm, return_peaks=True)
    flat = hm.permute(0, 3, 1, 2).reshape(1, hm.shape[-1], -1)
    assert torch.equal(idx.long(), flat.argmax(-1))


def test_bf16_input_is_upcast():
    hm = torch.from_numpy(_gaussians()).to(torch.bfloat16)
    c, m = tpeak.decode_heatmaps(hm)
    c32, m32 = tpeak.decode_heatmaps(hm.to(torch.float32))
    assert m.dtype == torch.float32
    assert torch.equal(c, c32) and torch.equal(m, m32)


@pytest.mark.parametrize('min_count', [0, 3, 24])
def test_select_confident_matches_jax(min_count):
    rng = np.random.default_rng(min_count)
    mv = rng.uniform(0.3, 0.9, size=(6, 30)).astype(np.float32)
    mv[0, :5] = 0.5                      # ties in the ranking
    want = peak.select_confident(jnp.asarray(mv), 0.6, min_count=min_count)
    got = tpeak.select_confident(torch.from_numpy(mv), 0.6,
                                 min_count=min_count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_NONE = 2 ** 31 - 1


def _fold(vals, idx, dim):
    """take_better folded along ``dim``: the largest value, and among
    equal values the smallest index (a total order, so any fold order)."""
    best = vals.amax(dim, keepdim=True)
    cand = torch.where(vals == best, idx, torch.full_like(idx, _NONE))
    return best.squeeze(dim), cand.amin(dim)


def _emulate_k1(hm, n_sm=132):
    """K1's argmax (csrc/peak_decode.cu) in torch: per image R bands of
    ceil(H/R) rows, each one flat run of rows*W*K floats read by T threads
    of VEC lanes; lane e = t*VEC + q of each sweep always holds keypoint
    e % K and moves T*VEC/K pixels per sweep; it keeps the first of its
    maxima (first element always taken, then strictly greater).  The CTA
    folds its lanes per keypoint, the cluster its ranks in rank order.
    Returns (row-major peak index (B, K), maxval (B, K))."""
    b, h, w, k = hm.shape
    ranks, band, vec, threads = launch_shape(b, h, w, k, n_sm)
    per = threads * vec
    assert per % k == 0
    out_v = torch.empty(b, k)
    out_i = torch.empty(b, k, dtype=torch.long)
    lane = torch.arange(per)
    for i in range(b):
        flat = hm[i].reshape(-1)
        rank_v, rank_i = [], []
        for r in range(ranks):
            r0 = r * band
            n = max(0, min(band, h - r0)) * w * k
            sweeps = max(1, -(-n // per))   # an empty band: one empty sweep
            e = torch.full((sweeps * per,), -torch.inf)
            e[:n] = flat[r0 * w * k:r0 * w * k + n]
            e = e.reshape(sweeps, per)
            pix = (r0 * w + torch.arange(sweeps)[:, None] * (per // k)
                   + lane[None] // k)
            first = e.argmax(0)              # the first of each lane's maxima
            v = e[first, lane]
            ix = pix[first, lane]
            empty = n <= lane                # no element of the band
            v[empty], ix[empty] = -torch.inf, _NONE
            rv, ri = _fold(v.reshape(per // k, k), ix.reshape(per // k, k), 0)
            rank_v.append(rv)
            rank_i.append(ri)
        out_v[i], out_i[i] = _fold(torch.stack(rank_v), torch.stack(rank_i), 0)
    return out_i, out_v


def _plateaus(b, h, w, k, seed):
    """Noise below 0.5 with equal maxima 0.9 in two, three or four places
    per map, spread over different bands and lanes, and one map whose
    maximum repeats within one lane."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.5, size=(b, h, w, k)).astype(np.float32)
    for i in range(b):
        for j in range(k):
            n = 2 + (i + j) % 3
            ys = rng.choice(h, size=n, replace=n > h)
            xs = rng.integers(0, w, size=n)
            hm[i, ys, xs, j] = 0.9
    # one lane's own tie: keypoint 0 of image 0 at pixel 1 and one sweep on
    _, _, vec, threads = launch_shape(b, h, w, k, 132)
    for p in (1, 1 + threads * vec // k):
        if p < h * w:
            hm[0, p // w, p % w, 0] = 0.95
    return hm


# (maps, label, SMs): many ranks on small batches (16 for 32 rows, with
# 16-byte lanes); 2 and 1 ranks where the card is full; vec 1 (W*K odd);
# bands of 2 rows with empty ranks (5 rows over 4, 9 rows over 8)
K1_CASES = [((2, 32, 32, 30), 'plateaus', 132),
            ((2, 32, 32, 30), 'zeros', 132),
            ((2, 32, 32, 30), 'plateaus', 4),
            ((2, 64, 48, 30), 'noise', 2),
            ((1, 20, 15, 7), 'plateaus', 132),
            ((2, 5, 16, 30), 'plateaus', 132),
            ((1, 9, 12, 30), 'plateaus', 132)]


@pytest.mark.parametrize('shape,label,n_sm', K1_CASES)
def test_band_split_keeps_first_maximum(shape, label, n_sm):
    rng = np.random.default_rng(sum(shape))
    hm = {'plateaus': lambda: _plateaus(*shape, seed=sum(shape)),
          'zeros': lambda: np.zeros(shape, np.float32),
          'noise': lambda: rng.uniform(size=shape).astype(np.float32)
          }[label]()
    t = torch.from_numpy(hm)
    idx, val = _emulate_k1(t, n_sm)
    ipk, mv = tpeak.argmax_peaks(t.permute(0, 3, 1, 2))
    assert torch.equal(val, mv)
    assert torch.equal(idx, (ipk[..., 1] * shape[2] + ipk[..., 0]).long())
    if label == 'zeros':
        assert not idx.any()
    if label == 'plateaus':   # ties were there to break
        assert bool(((t == 0.9).reshape(shape[0], -1, shape[3]).sum(1)
                     > 1).any())


def test_launch_constants_mirror_the_cuda_source():
    """The module's launch constants are those the kernel is built with."""
    src = (Path(k1_mod.__file__).resolve().parents[2] / 'csrc'
           / 'peak_decode.cu').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (-?\w+);', src))
    assert (int(consts['kMaxRanks']), int(consts['kMaxThreads'])) == (
        k1_mod._MAX_RANKS, k1_mod._MAX_THREADS)
    assert {int(consts['kErrShape']), int(consts['kErrCluster']),
            int(consts['kErrDevice'])} == set(k1_mod._ERRORS)
    assert 'const int unit = 32 / gcd(32, m) * m;' in src
    assert ('while (2 * B * c->ranks <= d->n_sm && 2 * c->ranks <= kMaxRanks'
            ' && 2 * c->ranks <= H)') in src
    assert launch_shape(64, 128, 128, 30, 132) == (2, 64, 4, 480)
    assert launch_shape(256, 128, 128, 30, 132) == (1, 128, 4, 480)
    assert launch_shape(1, 128, 128, 30, 132) == (16, 8, 4, 480)
    assert launch_shape(1, 20, 15, 7, 132) == (16, 2, 1, 448)
    assert launch_shape(64, 128, 128, 30, 132, aligned=False)[2:] == (1, 480)


# ------------------------------------------------------------------- DARK


def T(a):
    return torch.from_numpy(np.array(a))


def _dark_maps(seed, n=4):
    rng = np.random.default_rng(seed)
    kps = rng.uniform(8, 56, size=(n, 2))
    hm = np.asarray(heatmap.render_heatmaps(
        jnp.asarray(kps, jnp.float32), 64, 64, 2.0), np.float64)
    return np.clip(hm + rng.normal(scale=0.01, size=hm.shape), 0, 1
                   ).astype(np.float32)


@pytest.mark.parametrize('seed', [1, 2])
def test_dark_decode_matches_jax(seed):
    hm = _dark_maps(seed)
    jc, jm = peak.decode_heatmaps_dark(jnp.asarray(hm))
    tc, tm = tpeak.decode_heatmaps_dark(T(hm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        tpeak.gaussian_modulate(T(hm)).numpy(),
        np.asarray(peak.gaussian_modulate(jnp.asarray(hm))), atol=1e-6,
        rtol=0)


def test_dark_recovers_subpixel():
    kps = np.array([[30.42, 21.77]], np.float32)
    hm = np.asarray(heatmap.render_heatmaps(jnp.asarray(kps), 64, 64, 2.0))
    coords, _ = tpeak.decode_heatmaps_dark(T(hm))
    np.testing.assert_allclose(coords[0].numpy(), kps[0], atol=0.12)
