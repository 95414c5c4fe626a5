"""Peak decode of the port (``ops/peak.py``, the plain version of the CUDA
kernel ``csrc/peak_decode.cu``) against the JAX decode and the TPU kernel
run in the Pallas interpreter.

Tolerance: integer peaks and maxvals bitwise equal; coords atol 1e-5 (the
log and the stencil are the same f32 operations; only ``log``'s last bit
may differ between the two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.ops import heatmap, peak
from esa_pose_estimation_tpu.ops.pallas import decode_heatmaps_pallas
from esa_pose_estimation_tpu_torch.ops import peak as tpeak
from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import peak_decode


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


def test_channels_last_decode_matches_jax_nhwc_path():
    rng = np.random.default_rng(2)
    kps = rng.uniform(4, 60, size=(2, 7, 2)).astype(np.float32)
    nchw = np.asarray(heatmap.render_heatmaps(jnp.asarray(kps), 64, 64, 2.0))
    nchw = nchw + rng.uniform(0, 1e-3, nchw.shape).astype(np.float32)
    nhwc = np.ascontiguousarray(nchw.transpose(0, 2, 3, 1))
    c_ref, m_ref = peak.decode_heatmaps_auto_nhwc(jnp.asarray(nhwc))
    c_t, m_t = tpeak.decode_heatmaps_auto_nhwc(torch.from_numpy(nhwc))
    assert c_t.shape == (2, 7, 2) and m_t.shape == (2, 7)
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
