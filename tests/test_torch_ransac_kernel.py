"""The RANSAC-EPnP kernel (``csrc/ransac_epnp.cu``, its arithmetic in
``csrc/ransac_epnp.cuh``, its wrapper ``ops/kernels/ransac_epnp.py``)
against the plain version, ``ops/pnp.ransac_epnp_plain``.

On the CPU: the wrapper refuses what the kernel does not take before any
launch; CPU tensors take the plain version and never touch CUDA; the
wrapper's limits mirror the ``.cu``'s; and a host build of the kernel's
arithmetic (``tests/ransac_epnp_host.cpp``, compiled here with g++: the
kernel's phases in order, its reductions as sums in point order) against
the plain version on the cases every caller passes.

On the card (``card`` cases; they skip without one, and this file imports
no JAX)::

    python3 -m pytest --noconftest -p no:cacheprovider -q -s \
        tests/test_torch_ransac_kernel.py -m card

the kernel against the plain version on the same card, inputs and
uniforms: frames of the synthetic SPEED kind decoded by the r5 weights
through ``pipeline.make_jitted_pipeline`` at batch 1, 64 and 256, and the
other callers' cases.

Tolerances, both places (the two run the same f32 algorithm; sums over
points go in another order and the card fuses multiplies and adds, so a
hypothesis whose error sits within rounding of the threshold, or two
hypotheses whose scores tie within rounding, can go either way):

* the chosen hypothesis's inlier set equal on at least 99% of problems;
* rotation gap <= 1e-3 rad and relative translation gap <= 1e-3 at the
  99th percentile: one rounding-level flip of the chosen set moves a
  pose by the noise of its keypoints, below the serving check's 0.02 rad
  and 0.005 (PERF.md section 2), and otherwise the poses agree to
  ~1e-5;
* the final inliers equal wherever the chosen sets are equal: the same
  refit and LM then land within ~1e-5 px of each other, far from a
  5 px threshold.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu_torch import _build
from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.ops import epnp as tepnp
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.ops.kernels import ransac_epnp as kmod

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / 'esa_pose_estimation_tpu_torch' / 'csrc'
CHOSEN_SHARE = 0.99       # problems whose chosen inlier set is equal
ROT_P99 = 1e-3            # rad
TRANS_P99 = 1e-3          # relative


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problems(seed, batch, n=30, noise_px=0.7, n_out=3, p_invalid=0.15,
             depth=10.0, K=None):
    """(batch, n, 3) model points, their (batch, n, 2) projections under
    random poses with pixel noise and ``n_out`` gross outliers, and a
    (batch, n) valid mask."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    K = camera.speed_k().numpy() if K is None else K
    p3 = rng.uniform(-0.5, 0.5, size=(batch, n, 3))
    R = Rotation.random(batch, random_state=rng).as_matrix()
    t = np.stack([rng.uniform(-1, 1, batch), rng.uniform(-1, 1, batch),
                  depth + rng.uniform(-2, 2, batch)], -1)
    cam = np.einsum('bij,bnj->bni', R, p3) + t[:, None, :]
    uv = cam[..., :2] / cam[..., 2:3] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
    uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    for b in range(batch):
        out = rng.choice(n, n_out, replace=False)
        uv[b, out] += rng.uniform(-200, 200, size=(n_out, 2))
    valid = rng.uniform(size=(batch, n)) > p_invalid
    return (torch.tensor(p3, dtype=torch.float32),
            torch.tensor(uv, dtype=torch.float32), torch.tensor(valid))


def rotation_gap(Ra, Rb):
    """Angle of Ra^T Rb in f64 from its skew part (arccos of the trace
    loses ~4e-4 rad to f32 rounding near 0)."""
    M = Ra.double().transpose(-1, -2) @ Rb.double()
    w = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1)
    return torch.asin(torch.clamp(w.norm(dim=-1) / 2, max=1.0))


def plain_chosen(p3, p2, K, valid, masks, sample_size, thr=5.0):
    """The plain version's chosen hypothesis's inliers (B, N)."""
    shared = tepnp.epnp_precompute(p3, p2, K)
    score, inl = tpnp.hypothesis_scores(shared, p2, K, valid,
                                        masks.to(torch.float32),
                                        sample_size < 6, thr)
    best = torch.argmax(score, dim=-1)
    return inl[torch.arange(inl.shape[0]), best]


def assert_agree(ref, ref_chosen, got, got_chosen, label=''):
    """The module docstring's tolerances, on (R, t, inliers) of both."""
    same = (ref_chosen == got_chosen).all(-1)
    share = float(same.float().mean())
    rg = rotation_gap(ref[0], got[0])
    tg = ((ref[1] - got[1]).norm(dim=-1)
          / ref[1].norm(dim=-1).clamp(min=1e-12)).double()
    q = lambda x: float(torch.quantile(x, 0.99))      # noqa: E731
    msg = (f'{label}: chosen sets equal on {share:.4f}, rotation gap p99 '
           f'{q(rg):.3g} rad (max {float(rg.max()):.3g}), translation gap '
           f'p99 {q(tg):.3g}')
    print(msg)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all(), msg
    assert share >= CHOSEN_SHARE, msg
    assert q(rg) <= ROT_P99 and q(tg) <= TRANS_P99, msg
    assert (ref[2][same] == got[2][same]).all(), msg


# ------------------------------------------------------------------ wrapper


def _refuse(*a, **k):
    raise AssertionError('the kernel was built or launched')


REFUSED = {
    # case: (exception, what its message names)
    'points_f64': (TypeError, 'points_3d'),
    'keypoints_f16': (TypeError, 'points_2d'),
    'k_f64': (TypeError, 'K must be float32'),
    'uniforms_f64': (TypeError, 'uniforms'),
    'valid_int': (TypeError, 'valid'),
    'points_65': (ValueError, '1 to 64 points'),
    'points_none': (ValueError, '1 to 64 points'),
    'keypoints_shape': (ValueError, 'points_2d must be'),
    'k_shape': (ValueError, 'K must be'),
    'sample_0': (ValueError, 'sample_size'),
    'lm_negative': (ValueError, 'lm_iters'),
    'masks_width': (ValueError, 'masks or uniforms'),
    'keypoints_other_device': (RuntimeError, 'points_2d is on cpu'),
    'k_other_device': (RuntimeError, 'K is on cpu'),
    'uniforms_other_device': (RuntimeError, 'uniforms is on cpu'),
    'cpu': (RuntimeError, 'CUDA tensors expected'),
}


@pytest.mark.parametrize('case', list(REFUSED))
def test_wrapper_refuses_before_any_launch(monkeypatch, case):
    """What the kernel does not take raises in the wrapper: the build and
    the launch are never reached (here they would fail the test).  The
    tensors are on the meta device, whose type is not cuda either, so
    that the checks before the device's are seen on their own."""
    monkeypatch.setattr(_build, 'load', _refuse)
    monkeypatch.setattr(_build, 'build_all', _refuse)
    meta = torch.device('meta')
    n = 65 if case == 'points_65' else 0 if case == 'points_none' else 30
    p3 = torch.zeros((2, n, 3), device=meta)
    p2 = torch.zeros((2, n, 2), device=meta)
    K = torch.eye(3, device=meta)
    kw = dict(uniforms=torch.zeros((2, 8, n), device=meta))
    if case == 'points_f64':
        p3 = p3.double()
    elif case == 'keypoints_f16':
        p2 = p2.half()
    elif case == 'k_f64':
        K = K.double()
    elif case == 'uniforms_f64':
        kw['uniforms'] = kw['uniforms'].double()
    elif case == 'valid_int':
        kw['valid'] = torch.ones((2, n), dtype=torch.int32, device=meta)
    elif case == 'keypoints_shape':
        p2 = torch.zeros((2, 29, 2), device=meta)
    elif case == 'k_shape':
        K = torch.eye(4, device=meta)
    elif case == 'sample_0':
        kw['sample_size'] = 0
    elif case == 'lm_negative':
        kw['lm_iters'] = -1
    elif case == 'masks_width':
        kw = dict(masks=torch.zeros((2, 8, 29), device=meta))
    elif case == 'keypoints_other_device':
        p2 = torch.zeros((2, n, 2))
    elif case == 'k_other_device':
        K = torch.eye(3)
    elif case == 'uniforms_other_device':
        kw['uniforms'] = torch.zeros((2, 8, n))
    elif case == 'cpu':
        p3, p2, K = torch.zeros((2, n, 3)), torch.zeros((2, n, 2)), torch.eye(3)
        kw = {}
    before = kmod.ransac_epnp.launches
    exc, what = REFUSED[case]
    with pytest.raises(exc, match=what):
        kmod.ransac_epnp(p3, p2, K, **kw)
    assert kmod.ransac_epnp.launches == before


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """ransac_epnp on CPU tensors is ransac_epnp_plain, bit for bit, and
    never reaches the kernel, its build or CUDA."""
    monkeypatch.setattr(_build, 'load', _refuse)
    monkeypatch.setattr(_build, 'build_all', _refuse)
    monkeypatch.setattr(kmod, 'ransac_epnp', _refuse)
    monkeypatch.setattr(torch.cuda, '_lazy_init', _refuse)
    p3, p2, valid = problems(3, 4)
    K = camera.speed_k()
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(1), (4,),
                                  30, 16)
    got = tpnp.ransac_epnp(p3, p2, K, valid=valid, n_hypotheses=16,
                           uniforms=u)
    want = tpnp.ransac_epnp_plain(p3, p2, K, valid=valid, n_hypotheses=16,
                                  uniforms=u)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert isinstance(got, tpnp.PnPResult)


def test_launch_constants_mirror_the_cuda_source():
    """The wrapper's limits and error codes are those the kernel is built
    with, and it sizes the block as the .cu does."""
    src = (CSRC / 'ransac_epnp.cu').read_text()
    hdr = (CSRC / 'ransac_epnp.cuh').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (-?\w+);', src + hdr))
    assert int(consts['kMaxPoints']) == kmod._MAX_POINTS
    assert int(consts['kMaxThreads']) == kmod._MAX_THREADS
    assert int(consts['kMinThreads']) == kmod._MIN_THREADS
    assert {int(consts['kErrShape'])} == set(kmod._ERRORS)
    assert ('return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? '
            'kMaxThreads : t);') in src
    assert 'const int t = (h + 31) / 32 * 32;' in src
    assert [kmod.block_threads(h) for h in (1, 32, 64, 96, 100, 256, 1024)] \
        == [96, 96, 96, 96, 128, 256, 256]
    # every mirrored constant of the plain version the kernel uses
    assert 'kEps = 1e-9f' in hdr and tepnp._EPS == 1e-9
    assert [(a, b) for a, b in zip(tepnp._PAIR_A, tepnp._PAIR_B)] == [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    assert 'p < 3 ? 0 : (p < 5 ? 1 : 2)' in hdr
    assert 'p < 3 ? p + 1 : (p == 3 ? 2 : 3)' in hdr


# --------------------------------------------------------------- host build


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """The kernel's arithmetic built for the host with g++."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ for the host build of the kernel arithmetic')
    out = tmp_path_factory.mktemp('ransac_host') / 'libransac_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-shared', '-fPIC',
                    f'-I{CSRC}', '-o', str(out),
                    str(ROOT / 'tests' / 'ransac_epnp_host.cpp')],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)
    lib.ransac_epnp_host.argtypes = [P, P, P, P, P, I, P, L, I, I, I, I, I,
                                     F, F, P, P, P, P, P]
    lib.epnp_refit_host.argtypes = [P, P, P, P, P, I, P, P]
    return lib


def run_host(lib, p3, p2, K, valid, samples, masks, sample_size=6,
             lm_iters=10, thr=5.0):
    """The host build on contiguous CPU inputs: (R, t, inliers, cost),
    chosen."""
    b, n = p3.shape[:2]
    h = samples.shape[-2]
    sample_size = min(sample_size, n)
    K = K.expand(b, 3, 3).contiguous()
    samples = samples.to(torch.float32).contiguous()
    valid = None if valid is None else valid.contiguous()
    basis = kmod._bases(torch.device('cpu'))
    R = torch.empty((b, 3, 3))
    t = torch.empty((b, 3))
    inl = torch.empty((b, n), dtype=torch.bool)
    cost = torch.empty((b,))
    chosen = torch.empty((b, n), dtype=torch.bool)
    err = lib.ransac_epnp_host(
        p3.contiguous().data_ptr(), p2.contiguous().data_ptr(), K.data_ptr(),
        None if valid is None else valid.data_ptr(), samples.data_ptr(),
        int(masks), basis.data_ptr(), b, n, h, sample_size, lm_iters,
        int(sample_size < 6), thr, thr * 4.0, R.data_ptr(), t.data_ptr(),
        inl.data_ptr(), cost.data_ptr(), chosen.data_ptr())
    assert err == 0
    return (R, t, inl, cost), chosen


def lowest_first_masks(uniforms, valid, sample_size):
    """Gumbel top-k masks where ties go to the lower index (the kernel's
    rule): with fewer valid points than the sample, the invalid points of
    lowest index fill it."""
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(uniforms, min=tiny)))
    g = torch.where(valid[..., None, :], g, -torch.inf)
    idx = torch.sort(-g, dim=-1, stable=True).indices[..., :sample_size]
    return torch.zeros_like(uniforms).scatter_(-1, idx, 1.0)


HOST_CASES = {
    # (seed, batch, points, hypotheses, sample size, threshold px,
    #  problems' keywords).  sample_4: 4-point hypotheses are well posed
    # only near and with little noise: at 10 m and 0.7 px the plain
    # version alone picks another set on 2-5% of problems between f32 and
    # f64.  few_inliers: a threshold under the keypoints' noise leaves
    # almost every chosen set of 5-point samples under 4 points, so the
    # refit takes all valid points (6-point samples fit their own points
    # exactly).
    'serving': (11, 32, 30, 64, 6, 5.0, {}),
    'linemod': (12, 32, 9, 32, 6, 5.0, dict(n_out=1, p_invalid=0.05)),
    'sample_4': (13, 24, 30, 32, 4, 5.0, dict(depth=3.0, noise_px=0.1,
                                              n_out=0)),
    'few_inliers': (14, 24, 30, 32, 5, 0.02, dict(noise_px=2.0, n_out=0)),
}


@pytest.mark.parametrize('case', sorted(HOST_CASES))
def test_host_build_matches_the_plain_version(host, case):
    """Sampling from uniforms, every hypothesis, the choice, the refit
    (on all valid points where the chosen set has fewer than 4) and the
    LM, against ransac_epnp_plain on the same uniforms."""
    seed, b, n, h, s, thr, kw = HOST_CASES[case]
    p3, p2, valid = problems(seed, b, n=n, **kw)
    K = camera.speed_k()
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(seed),
                                  (b,), n, h)
    ref = tpnp.ransac_epnp_plain(p3, p2, K, valid=valid, n_hypotheses=h,
                                 sample_size=s, uniforms=u,
                                 reproj_threshold=thr)
    masks = tpnp._sample_masks(None, (b,), n, h, s, valid, u)
    got, chosen = run_host(host, p3, p2, K, valid, u, False, s, thr=thr)
    ref_chosen = plain_chosen(p3, p2, K, valid, masks, s, thr)
    if case == 'few_inliers':
        # a chosen set under 4 points gives way to all valid points: the
        # set the refit takes is compared
        assert (ref_chosen.sum(-1) < 4).float().mean() >= 0.9
        ref_chosen, chosen = (
            torch.where((c.sum(-1) >= 4)[:, None], c, valid)
            for c in (ref_chosen, chosen))
    assert_agree(ref, ref_chosen, got, chosen, case)
    assert torch.allclose(got[3], ref.cost, rtol=1e-3, atol=1e-9)


def assert_few_valid_agree(ref, ref_chosen, got, got_chosen, label):
    """Frames with fewer valid points than the sample: the chosen sets
    (sampling, hypotheses and choice) as in :func:`assert_agree`, and
    finite poses.  The poses are not compared: the refit of 4 or 5 points
    is ill-posed, and the plain version alone moves by up to 0.68 rad
    between f32 and f64 on such frames (seeds 15 and 16 here)."""
    share = float((ref_chosen == got_chosen).all(-1).float().mean())
    print(f'{label}: chosen sets equal on {share:.4f}')
    assert share >= CHOSEN_SHARE
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


def test_host_build_with_masks_and_few_valid_points(host):
    """Injected masks, and frames with fewer valid points than the sample
    (the sample then holds invalid points; here the plain version's own
    masks are injected, whatever its topk picked among them)."""
    p3, p2, valid = problems(15, 24)
    valid[:8, 5:] = False               # 5 valid points in 8 frames
    K = camera.speed_k()
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(15), (24,),
                                  30, 64)
    masks = tpnp._sample_masks(None, (24,), 30, 64, 6, valid, u)
    ref = tpnp.ransac_epnp_plain(p3, p2, K, valid=valid, masks=masks)
    got, chosen = run_host(host, p3, p2, K, valid, masks, True)
    ref_chosen = plain_chosen(p3, p2, K, valid, masks, 6)
    assert_agree([x[8:] for x in ref], ref_chosen[8:], [x[8:] for x in got],
                 chosen[8:], 'masks')
    assert_few_valid_agree([x[:8] for x in ref], ref_chosen[:8],
                           [x[:8] for x in got], chosen[:8], 'masks, 5 valid')


def test_host_sampling_fills_with_the_lowest_invalid_points(host):
    """With fewer valid points than the sample, the kernel's top-k takes
    the invalid points of lowest index among the tied -inf keys."""
    p3, p2, valid = problems(16, 16)
    valid[:, 4:] = False
    K = camera.speed_k()
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(16), (16,),
                                  30, 32)
    masks = lowest_first_masks(u, valid, 6)
    assert torch.equal(masks[..., :6].sum(-1), torch.full((16, 32), 6.0))
    ref = tpnp.ransac_epnp_plain(p3, p2, K, valid=valid, masks=masks)
    got, chosen = run_host(host, p3, p2, K, valid, u, False)
    assert_few_valid_agree(ref, plain_chosen(p3, p2, K, valid, masks, 6), got,
                           chosen, 'few valid')


def test_host_refit_matches_epnp_from_mask(host):
    """The refit alone (beta refinement, mirror and Kabsch) against
    epnp_from_mask on the same weights."""
    p3, p2, valid = problems(17, 16, n_out=0)
    K = camera.speed_k()
    basis = kmod._bases(torch.device('cpu'))
    for b in range(16):
        w = valid[b].to(torch.float32).contiguous()
        R0, t0 = tepnp.epnp_from_mask(
            tepnp.epnp_precompute(p3[b], p2[b], K), w)
        R, t = torch.empty((3, 3)), torch.empty(3)
        assert host.epnp_refit_host(
            p3[b].contiguous().data_ptr(), p2[b].contiguous().data_ptr(),
            K.contiguous().data_ptr(), w.data_ptr(), basis.data_ptr(), 30,
            R.data_ptr(), t.data_ptr()) == 0
        assert float(rotation_gap(R0, R)) < 1e-4
        assert float((t - t0).norm() / t0.norm()) < 1e-4


# --------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _build.build_all()
    return torch.device('cuda')


def kernel_vs_plain(p3, p2, K, valid, u, sample_size=6, thr=5.0,
                    masks=None):
    """Both versions on the card on the same inputs and uniforms (or
    masks): (plain result, its chosen set), (kernel result, its chosen
    set)."""
    b, n = p3.shape[:2]
    h = (masks if masks is not None else u).shape[-2]
    kw = dict(valid=valid, n_hypotheses=h, sample_size=sample_size,
              reproj_threshold=thr)
    if masks is None:
        kw['uniforms'] = u
        masks = tpnp._sample_masks(None, (b,), n, h, min(sample_size, n),
                                   valid, u)
    else:
        kw['masks'] = masks
    ref = tpnp.ransac_epnp_plain(p3, p2, K, **kw)
    got = kmod.ransac_epnp(p3, p2, K, return_chosen=True, **kw)
    torch.cuda.synchronize()
    ref_chosen = plain_chosen(p3, p2, K, valid, masks, sample_size, thr)
    return ((tuple(x.cpu() for x in ref), ref_chosen.cpu()),
            (tuple(x.cpu() for x in got[:4]), got[4].cpu()))


@pytest.fixture(scope='module')
def r5_keypoints():
    """256 frames of the synthetic SPEED kind served by the r5 weights
    (bf16, the serving form) through make_jitted_pipeline with the
    benchmark's serving settings: the keypoints, the selection and the
    keypoint model on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )
    dev = torch.device('cuda')
    model = load_hrnet_artifact(str(ROOT / 'artifacts' / 'esa_syn_r5.npz'),
                                dtype=torch.bfloat16, device=dev)
    pts = synthetic.spacecraft_points(device=dev)
    s = synthetic.make_sample(torch.Generator(device=dev).manual_seed(2031),
                              pts, 256)
    serve = pipeline.make_jitted_pipeline(model, pts, n_hypotheses=64,
                                          min_keypoints=0)
    out = serve(s.image, s.bbox, torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    return (pts.expand((256,) + pts.shape), out.keypoints_2d.contiguous(),
            out.selected.contiguous())


@pytest.mark.card
@pytest.mark.parametrize('batch', [1, 64, 256])
def test_card_kernel_matches_plain_on_r5_frames(card, r5_keypoints, batch):
    """The serving problem: 30 keypoints decoded by r5, its selection, 64
    hypotheses, sample 6, 10 LM steps."""
    p3, p2, valid = (x[:batch] for x in r5_keypoints)
    u = tpnp.draw_ransac_uniforms(
        torch.Generator(device=card).manual_seed(batch), (batch,), 30, 64,
        card)
    ref, got = kernel_vs_plain(p3, p2, camera.speed_k(device=card), valid, u)
    assert_agree(*ref, *got, f'r5 frames, batch {batch}')


@pytest.mark.card
@pytest.mark.parametrize('case', sorted(HOST_CASES))
def test_card_kernel_matches_plain_on_other_callers(card, case):
    """LINEMOD's 9 points and 32 hypotheses, sample 4 (beta refinement in
    every hypothesis), and the fallback to all valid points, on the card,
    at the host build's cases with 16 times the problems (384 to 512: the
    99% and the 99th percentile leave room for rounding-level flips)."""
    seed, b, n, h, s, thr, kw = HOST_CASES[case]
    p3, p2, valid = (x.to(card) for x in problems(seed, 16 * b, n=n, **kw))
    u = tpnp.draw_ransac_uniforms(
        torch.Generator(device=card).manual_seed(seed), (16 * b,), n, h,
        card)
    ref, got = kernel_vs_plain(p3, p2, camera.speed_k(device=card), valid, u,
                               s, thr)
    if case == 'few_inliers':
        assert (ref[1].sum(-1) < 4).float().mean() >= 0.9
        ref, got = ((r, torch.where((c.sum(-1) >= 4)[:, None], c,
                                    valid.cpu())) for r, c in (ref, got))
    assert_agree(*ref, *got, f'card {case}')


@pytest.mark.card
def test_card_masks_per_problem_k_and_few_valid_points(card):
    """Injected masks with a K per problem and leading batch dims (2, 48),
    and frames with 5 valid points, sampled by each version from the same
    uniforms: the card's torch.topk and the kernel take the same invalid
    points among the tied -inf keys (read here first), so the chosen sets
    compare; their poses are not compared (assert_few_valid_agree)."""
    p3, p2, valid = (x.to(card) for x in problems(18, 96))
    K = camera.speed_k(device=card).expand(96, 3, 3).clone()
    K[:, :2, 2] += torch.linspace(-20, 20, 96, device=card)[:, None]
    masks = (torch.rand((96, 64, 30), generator=torch.Generator(
        device=card).manual_seed(18), device=card) < 0.2).float()
    lead = lambda x: x.reshape((2, 48) + x.shape[1:])      # noqa: E731
    ref = tpnp.ransac_epnp_plain(p3, p2, K, valid=valid, masks=masks)
    got = kmod.ransac_epnp(lead(p3), lead(p2), lead(K), valid=lead(valid),
                           masks=lead(masks), return_chosen=True)
    got = [x.reshape((96,) + x.shape[2:]).cpu() for x in got]
    assert_agree(tuple(x.cpu() for x in ref),
                 plain_chosen(p3, p2, K, valid, masks, 6).cpu(),
                 tuple(got[:4]), got[4], 'card masks')

    few = valid.clone()
    few[:, 5:] = False
    u = tpnp.draw_ransac_uniforms(
        torch.Generator(device=card).manual_seed(19), (96,), 30, 64, card)
    topk = tpnp._sample_masks(None, (96,), 30, 64, 6, few, u)
    lowest = lowest_first_masks(u, few, 6)
    picked = sorted({int(i) for i in torch.nonzero(
        topk * ~few[:, None, :])[:, 2].tolist()})
    print(f'card topk among -inf: invalid points picked {picked}; the '
          f'lowest-index rule {"matches" if torch.equal(topk, lowest) else "differs"}')
    assert torch.equal(topk, lowest)
    ref, got = kernel_vs_plain(p3, p2, K, few, u)
    assert_few_valid_agree(*ref, *got, 'card, 5 valid')
