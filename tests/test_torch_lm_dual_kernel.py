"""The dual LM kernel (``csrc/lm_dual.cu``, its arithmetic in
``csrc/lm_dual.cuh`` and ``csrc/ransac_epnp.cuh``, its wrapper
``ops/kernels/lm_dual.py``) against the plain version,
``ops/pnp.refine_pose_plain``.

On the CPU: the wrapper refuses what the kernel does not take before any
launch; CPU tensors take the plain version, bit for bit the chain the
serving path ran before the kernel, and never touch CUDA; the wrapper's
constants mirror the ``.cu``'s; the graphs count its launches; and a host
build of the kernel's arithmetic (``tests/lm_dual_host.cpp``, compiled
here with g++: the candidates in turn, its reductions as sums in point
order) against the plain version on the cases every caller passes.

On the card (``card`` cases; they skip without one, and this file imports
no JAX)::

    python3 -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_lm_dual_kernel.py -m card

the kernel against the plain version on the same card and inputs: frames
of the synthetic SPEED kind served by the r5 weights through
``pipeline.make_jitted_pipeline`` at batch 1, 64 and 256, a ViTPose-shaped
case at stride 4, the other callers' cases; one ``lm_dual`` launch per
serving call by the graph's counts and the profiler; and the RANSAC-EPnP
kernel, which shares the LM and the mirror, bit for bit the outputs it
gave before they were shared (``tests/fixtures/ransac_epnp_card.npz``).

Tolerances, both places (the two run the same f32 algorithm; sums over
points go in another order and the card fuses multiplies and adds):

* the candidate kept the same on at least 99% of problems;
* rotation gap <= 1e-3 rad and relative translation gap <= 1e-3 at the
  99th percentile, those of ``tests/test_torch_ransac_kernel.py``.
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
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.ops.kernels import lm_dual as kmod
from esa_pose_estimation_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / 'esa_pose_estimation_tpu_torch' / 'csrc'
RANSAC_FIXTURE = ROOT / 'tests' / 'fixtures' / 'ransac_epnp_card.npz'
PICK_SHARE = 0.99         # problems whose kept candidate is the same
ROT_P99 = 1e-3            # rad
TRANS_P99 = 1e-3          # relative
ITERS = 10                # the serving path's LM steps


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation(rng, batch, angle=None):
    """Random rotations, or rotations by ``angle`` rad about random axes."""
    from scipy.spatial.transform import Rotation
    if angle is None:
        return Rotation.random(batch, random_state=rng).as_matrix()
    axis = rng.normal(size=(batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return Rotation.from_rotvec(axis * angle).as_matrix()


def problems(seed, batch, n=30, noise_px=0.7, depth=10.0, crop=128,
             stride=1, heatmaps=True, hm_dtype=torch.float32, k_per=False,
             p_unsel=0.15, inliers=True, few_kept=0.0, none_selected=0.0,
             one_model=False):
    """The refine stage's inputs for ``batch`` problems of ``n`` keypoints
    under random poses with pixel noise: points_3d, keypoints in pixels,
    confidences, the selection, RANSAC's inliers (or None), a start pose
    near the truth or, in every other problem, near the truth's mirror
    (so that both candidates are kept somewhere), K (shared or per
    problem), and Gaussian heatmaps (B, S, S, n) of side crop / stride at
    the keypoints (or None) with the rates (heatmap pixels per frame
    pixel) and int32 crop origins that place them.  ``few_kept``: the
    share of problems whose inliers leave under 4 selected points;
    ``none_selected``: the share with nothing selected; ``one_model``: one
    keypoint model for every problem, as in serving."""
    rng = np.random.default_rng(seed)
    K = np.broadcast_to(camera.speed_k().numpy(), (batch, 3, 3)).copy()
    if k_per:
        K[:, :2, 2] += rng.uniform(-30, 30, size=(batch, 2))
    p3 = rng.uniform(-0.5, 0.5, size=(1 if one_model else batch, n, 3))
    p3 = np.broadcast_to(p3, (batch, n, 3)).copy()
    R = _rotation(rng, batch)
    t = np.stack([rng.uniform(-1, 1, batch), rng.uniform(-1, 1, batch),
                  depth + rng.uniform(-2, 2, batch)], -1)
    cam = np.einsum('bij,bnj->bni', R, p3) + t[:, None, :]
    f = K[:, None, [0, 1], [0, 1]]
    c = K[:, None, [0, 1], [2, 2]]
    uv = cam[..., :2] / cam[..., 2:3] * f + c
    uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    conf = rng.uniform(0.2, 1.0, size=(batch, n))
    sel = rng.uniform(size=(batch, n)) > p_unsel
    inl = rng.uniform(size=(batch, n)) > 0.1
    few = rng.uniform(size=batch) < few_kept
    inl[few] = False
    inl[few, :2] = True
    sel[rng.uniform(size=batch) < none_selected] = False

    T = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt)  # noqa: E731
    R0 = _rotation(rng, batch, 0.05) @ R
    t0 = t + rng.normal(scale=0.05, size=t.shape)
    R0, t0 = T(R0), T(t0)
    mirrored = torch.arange(batch) % 2 == 1
    Rm, tm = tpnp.mirror_pose(T(p3), R0, t0, torch.ones((batch, n)))
    R0 = torch.where(mirrored[:, None, None], Rm, R0)
    t0 = torch.where(mirrored[:, None], tm, t0)
    out = dict(points_3d=T(p3), points_2d=T(uv), confidences=T(conf), K=T(K),
               R0=R0, t0=t0, select=torch.tensor(sel),
               inliers=torch.tensor(inl) if inliers else None,
               heatmaps=None, rates=None, origins=None)
    if heatmaps:
        lo, hi = uv.min(1), uv.max(1)
        size = (hi - lo).max(-1) * 1.05 + 24.0
        origins = np.floor((lo + hi) / 2 - size[:, None] / 2).astype(np.int32)
        rates = crop / size / stride                # heatmap px per frame px
        side = crop // stride
        at = (uv - origins[:, None, :]) * rates[:, None, None]  # (B, n, 2)
        g = np.arange(side, dtype=np.float64)
        gx = np.exp(-(g[None, None, :] - at[..., 0:1]) ** 2 / 8.0)
        gy = np.exp(-(g[None, None, :] - at[..., 1:2]) ** 2 / 8.0)
        hm = np.einsum('bky,bkx->byxk', gy, gx)        # (B, S, S, n)
        out.update(heatmaps=T(hm).to(hm_dtype), rates=T(rates),
                   origins=torch.tensor(origins))
    return out


def rotation_gap(Ra, Rb):
    """Angle of Ra^T Rb in f64 from its skew part (arccos of the trace
    loses ~4e-4 rad to f32 rounding near 0)."""
    M = Ra.double().transpose(-1, -2) @ Rb.double()
    w = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1)
    return torch.asin(torch.clamp(w.norm(dim=-1) / 2, max=1.0))


def plain_pick(pr, disambiguate=True):
    """The candidate refine_pose_plain keeps (B,), 0 without a mirror, and
    where its two candidates are distinct (B,) bool: more than the
    tolerances apart.  Where both converge to one pose, which is kept
    turns on rounding and cannot be seen in the result."""
    b = pr['points_3d'].shape[0]
    dev = pr['points_3d'].device
    if not disambiguate:
        return (torch.zeros(b, dtype=torch.int64, device=dev),
                torch.zeros(b, dtype=torch.bool, device=dev))
    w = tpnp.refine_weights(pr['confidences'], pr['select'], pr['inliers'])
    ev = None
    if pr['heatmaps'] is not None:
        ev = tpnp.heatmap_evidence(pr['heatmaps'].to(torch.float32),
                                   pr['points_3d'], pr['K'], pr['rates'],
                                   pr['origins'], valid=pr['select'])
    R, t, pick = tpnp.dual_candidates(pr['points_3d'], pr['points_2d'], w,
                                      pr['K'], pr['R0'], pr['t0'], ITERS, ev)
    tg = (t[0] - t[1]).norm(dim=-1) / t[0].norm(dim=-1).clamp(min=1e-12)
    return pick, (rotation_gap(R[0], R[1]) > ROT_P99) | (tg > TRANS_P99)


def assert_agree(ref, ref_pick, got, got_pick, label=''):
    """The module docstring's tolerances, on (R, t) of both, and on the
    kept candidate where the two candidates are distinct (``ref_pick``:
    :func:`plain_pick`'s pair)."""
    pick, distinct = (x.cpu() for x in ref_pick)
    same = pick == got_pick.cpu().long()
    share = float(same[distinct].float().mean()) if distinct.any() else 1.0
    rg = rotation_gap(ref[0].cpu(), got[0].cpu())
    tg = ((ref[1] - got[1]).norm(dim=-1)
          / ref[1].norm(dim=-1).clamp(min=1e-12)).double().cpu()
    q = lambda x: float(torch.quantile(x, 0.99))      # noqa: E731
    msg = (f'{label}: kept candidate equal on {share:.4f} of the '
           f'{int(distinct.sum())} of {len(pick)} problems whose candidates '
           f'are distinct (mirror kept on {float(pick.float().mean()):.2f}), '
           f'rotation gap p99 {q(rg):.3g} rad (max {float(rg.max()):.3g}), '
           f'translation gap p99 {q(tg):.3g}')
    print(msg)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all(), msg
    assert share >= PICK_SHARE, msg
    assert q(rg) <= ROT_P99 and q(tg) <= TRANS_P99, msg
    return distinct


# ------------------------------------------------------------------ wrapper


def _refuse(*a, **k):
    raise AssertionError('the kernel was built or launched')


REFUSED = {
    # case: (exception, what its message names)
    'points_f64': (TypeError, 'points_3d must be float32'),
    'confidences_f16': (TypeError, 'confidences must be float32'),
    'select_int': (TypeError, 'select must be bool'),
    'heatmaps_f16': (TypeError, 'heatmaps must be float32 or bfloat16'),
    'origins_f32': (TypeError, 'origins must be int32'),
    'points_65': (ValueError, '1 to 64 points'),
    'points_none': (ValueError, '1 to 64 points'),
    'keypoints_shape': (ValueError, 'points_2d must be'),
    'r0_shape': (ValueError, 'R0 must be'),
    'heatmaps_not_square': (ValueError, 'heatmaps must be'),
    'heatmaps_channels': (ValueError, 'heatmaps must be'),
    'heatmaps_no_rates': (ValueError, 'need rates and origins'),
    'k_shape': (ValueError, 'K must be'),
    'iters_negative': (ValueError, 'iters'),
    'r0_other_device': (RuntimeError, 'R0 is on cpu'),
    'heatmaps_other_device': (RuntimeError, 'heatmaps is on cpu'),
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
    cpu = torch.device('cpu')
    meta = cpu if case == 'cpu' else torch.device('meta')
    n = 65 if case == 'points_65' else 0 if case == 'points_none' else 30
    z = lambda *s, **k: torch.zeros(s, device=k.get('device', meta),  # noqa
                                    dtype=k.get('dtype', torch.float32))
    a = dict(points_3d=z(2, n, 3), points_2d=z(2, n, 2),
             confidences=z(2, n), K=torch.eye(3, device=meta),
             R0=z(2, 3, 3), t0=z(2, 3), select=z(2, n, dtype=torch.bool),
             heatmaps=z(2, 16, 16, n), rates=z(2),
             origins=z(2, 2, dtype=torch.int32))
    if case == 'points_f64':
        a['points_3d'] = a['points_3d'].double()
    elif case == 'confidences_f16':
        a['confidences'] = a['confidences'].half()
    elif case == 'select_int':
        a['select'] = z(2, n, dtype=torch.int32)
    elif case == 'heatmaps_f16':
        a['heatmaps'] = a['heatmaps'].half()
    elif case == 'origins_f32':
        a['origins'] = z(2, 2)
    elif case == 'keypoints_shape':
        a['points_2d'] = z(2, 29, 2)
    elif case == 'r0_shape':
        a['R0'] = z(3, 3, 3)
    elif case == 'heatmaps_not_square':
        a['heatmaps'] = z(2, 16, 8, n)
    elif case == 'heatmaps_channels':
        a['heatmaps'] = z(2, 16, 16, n + 1)
    elif case == 'heatmaps_no_rates':
        a['rates'] = None
    elif case == 'k_shape':
        a['K'] = torch.eye(4, device=meta)
    elif case == 'iters_negative':
        a['iters'] = -1
    elif case == 'r0_other_device':
        a['R0'] = z(2, 3, 3, device=cpu)
    elif case == 'heatmaps_other_device':
        a['heatmaps'] = z(2, 16, 16, n, device=cpu)
    before = kmod.refine_pose.launches
    exc, what = REFUSED[case]
    with pytest.raises(exc, match=what):
        kmod.refine_pose(**a)
    assert kmod.refine_pose.launches == before


def parent_chain(pr, disambiguate=True):
    """The refine stage as the serving path ran it before the kernel: the
    weights' prelude, then heatmap_evidence and lm_refine_dual, or
    lm_refine."""
    keep = pr['inliers'] & pr['select']
    enough = (keep.sum(-1) >= 4)[..., None]
    keep = torch.where(enough, keep, pr['select'])
    w = torch.where(keep, pr['confidences'], 0.0)
    args = (pr['points_3d'], pr['points_2d'], w, pr['K'], pr['R0'], pr['t0'])
    if not disambiguate:
        return tpnp.lm_refine(*args, iters=ITERS)
    ev = tpnp.heatmap_evidence(pr['heatmaps'].to(torch.float32),
                               pr['points_3d'], pr['K'], pr['rates'],
                               pr['origins'], valid=pr['select'])
    return tpnp.lm_refine_dual(*args, iters=ITERS, evidence_fn=ev)


@pytest.mark.parametrize('disambiguate', [True, False])
def test_cpu_tensors_take_the_plain_version(monkeypatch, disambiguate):
    """refine_pose on CPU tensors is refine_pose_plain, and both are the
    serving path's chain before the kernel, bit for bit; nothing reaches
    the kernel, its build or CUDA."""
    monkeypatch.setattr(_build, 'load', _refuse)
    monkeypatch.setattr(_build, 'build_all', _refuse)
    monkeypatch.setattr(kmod, 'refine_pose', _refuse)
    monkeypatch.setattr(torch.cuda, '_lazy_init', _refuse)
    pr = problems(3, 8, few_kept=0.3)
    kw = dict(iters=ITERS, disambiguate=disambiguate)
    got = tpnp.refine_pose(**pr, **kw)
    for want in (tpnp.refine_pose_plain(**pr, **kw),
                 parent_chain(pr, disambiguate)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_launch_constants_mirror_the_cuda_source():
    """The wrapper's limits and error codes are those the kernel is built
    with, and the launch gives each candidate a warp."""
    src = (CSRC / 'lm_dual.cu').read_text()
    hdr = (CSRC / 'lm_dual.cuh').read_text() + (
        CSRC / 'ransac_epnp.cuh').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (-?\w+);', src + hdr))
    assert int(consts['kMaxPoints']) == kmod._MAX_POINTS
    assert int(consts['kMaxCandidates']) == kmod._MAX_CANDIDATES
    assert {int(consts['kErrShape'])} == set(kmod._ERRORS)
    assert '__launch_bounds__(32 * kMaxCandidates)' in src
    assert '<<<static_cast<unsigned>(B), 32 * ncand, 0,' in src
    # the plain version's constants the kernel copies
    assert 'popcount(k) >= 4 ? k : sel' in hdr
    assert '1e-6f * (m + 1e-12f)' in hdr
    assert 'float lam = 1e-3f;' in hdr


def test_graphs_count_lm_dual_launches():
    """A replay adds the kernel's launches to its counter, under the label
    lm_dual (Graphed.stats())."""
    counts = {label: (c, n) for label, c, n in graphs._counts()}
    assert counts['lm_dual'] == (kmod.refine_pose, 'launches')
    assert isinstance(kmod.refine_pose.launches, int)


# --------------------------------------------------------------- host build


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """The kernel's arithmetic built for the host with g++."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ for the host build of the kernel arithmetic')
    out = tmp_path_factory.mktemp('lm_dual_host') / 'liblm_dual_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-shared', '-fPIC',
                    f'-I{CSRC}', '-o', str(out),
                    str(ROOT / 'tests' / 'lm_dual_host.cpp')],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lm_dual_host.argtypes = [P, P, P, P, P, P, P, P, P, I, I, P, P, L, I,
                                 I, I, P, P, P, P, P]
    return lib


def run_host(lib, pr, disambiguate=True):
    """The host build on contiguous CPU inputs: (R, t), the kept
    candidate, and each candidate's cost and evidence."""
    b, n = pr['points_3d'].shape[:2]
    c = lambda x: None if x is None else x.contiguous()  # noqa: E731
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    K = c(pr['K'].expand(b, 3, 3))
    hm = pr['heatmaps']
    bf16 = hm is not None and hm.dtype == torch.bfloat16
    if bf16:
        hm = hm.view(torch.int16)
    hm = c(hm)
    rates = c(pr['rates'])
    origins = c(pr['origins'])
    keep = [c(pr[k]) for k in ('points_3d', 'points_2d', 'confidences',
                               'select', 'inliers', 'R0', 't0')]
    R = torch.empty((b, 3, 3))
    t = torch.empty((b, 3))
    picked = torch.empty((b,), dtype=torch.uint8)
    cost = torch.empty((b, 2))
    ev = torch.empty((b, 2))
    err = lib.lm_dual_host(
        *[ptr(x) for x in keep[:2]], ptr(K), *[ptr(x) for x in keep[2:]],
        ptr(hm), int(bf16), 0 if hm is None else hm.shape[1], ptr(rates),
        ptr(origins), b, n, ITERS, 2 if disambiguate else 1, R.data_ptr(),
        t.data_ptr(), picked.data_ptr(), cost.data_ptr(), ev.data_ptr())
    assert err == 0
    return (R, t), picked, cost, ev


CASES = {
    # (seed, batch, problems' keywords, disambiguate).  evidence: the
    # serving path (30 keypoints, heatmap evidence over the selection);
    # cost: mirror_evidence other than 'heatmap'; single: disambiguate
    # False; linemod_9 / _32: solve_pose on LINEMOD's keypoints (the
    # selection, no inlier set, the choice by cost); per_problem_k: a K a
    # problem; stride4_bf16: bf16 maps a quarter of the crop's side;
    # few_kept: RANSAC leaves under 4 selected inliers in half the
    # problems (the selection is weighted instead); none_selected: nothing
    # selected in a third (min_keypoints 0 allows it: every weight zero);
    # points_64: the kernel's most points.
    'evidence': (21, 64, {}, True),
    'cost': (22, 32, dict(heatmaps=False), True),
    'single': (23, 32, {}, False),
    'linemod_9': (24, 32, dict(n=9, heatmaps=False, inliers=False,
                               p_unsel=0.05), True),
    'linemod_32': (25, 32, dict(n=32, heatmaps=False, inliers=False), True),
    'per_problem_k': (26, 32, dict(k_per=True), True),
    'stride4_bf16': (27, 32, dict(crop=256, stride=4,
                                  hm_dtype=torch.bfloat16), True),
    'few_kept': (28, 32, dict(few_kept=0.5), True),
    'none_selected': (29, 32, dict(none_selected=0.34), True),
    'points_64': (30, 16, dict(n=64), True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_host_build_matches_the_plain_version(host, case):
    """The weights, the mirror, LM on each candidate, the evidence and the
    choice, against refine_pose_plain on the same inputs."""
    seed, b, kw, dual = CASES[case]
    pr = problems(seed, b, **kw)
    ref = tpnp.refine_pose_plain(**pr, iters=ITERS, disambiguate=dual)
    got, picked, cost, ev = run_host(host, pr, dual)
    distinct = assert_agree(ref, plain_pick(pr, dual), got, picked, case)
    if dual and case != 'none_selected':
        assert int(distinct.sum()) >= 4, 'the candidates agree'
    if case == 'none_selected':
        nothing = ~pr['select'].any(-1)
        assert nothing.any() and (picked[nothing] == 0).all()
        assert (cost[nothing] == 0).all() and (ev[nothing] == 0).all()
        assert torch.equal(got[0][nothing], pr['R0'][nothing])


# --------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _build.build_all()
    return torch.device('cuda')


def to(pr, dev):
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in pr.items()}


def kernel_vs_plain(pr, dual=True, label=''):
    """Both versions on the card on the same inputs, compared."""
    ref = tpnp.refine_pose_plain(**pr, iters=ITERS, disambiguate=dual)
    ref_pick = plain_pick(pr, dual)
    got = kmod.refine_pose(**pr, iters=ITERS, disambiguate=dual,
                           return_pick=True)
    torch.cuda.synchronize()
    assert_agree(ref, ref_pick, got[:2], got[2], label)


@pytest.fixture(scope='module')
def r5_served():
    """256 frames of the synthetic SPEED kind served by the r5 weights
    (bf16, the serving form) through make_jitted_pipeline with the
    benchmark's serving settings, and RANSAC-EPnP on its keypoints: the
    refine stage's inputs on the card."""
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
    s = synthetic.make_sample(torch.Generator(device=dev).manual_seed(2041),
                              pts, 256)
    serve = pipeline.make_jitted_pipeline(model, pts, n_hypotheses=64,
                                          min_keypoints=0, lm_iters=ITERS)
    out = serve(s.image, s.bbox, torch.Generator(device=dev).manual_seed(8))
    p3 = pts.expand((256,) + pts.shape)
    K = camera.speed_k(device=dev)
    u = tpnp.draw_ransac_uniforms(torch.Generator(device=dev).manual_seed(9),
                                  (256,), 30, 64, dev)
    init = tpnp.ransac_epnp(p3, out.keypoints_2d, K, valid=out.selected,
                            n_hypotheses=64, lm_iters=ITERS, uniforms=u)
    torch.cuda.synchronize()
    return dict(points_3d=p3, points_2d=out.keypoints_2d.clone(),
                confidences=out.confidences.clone(), K=K, R0=init.R,
                t0=init.t, select=out.selected.clone(), inliers=init.inliers,
                heatmaps=out.heatmaps.clone(), rates=out.rates.clone(),
                origins=out.origins.clone())


@pytest.mark.card
@pytest.mark.parametrize('batch', [1, 64, 256])
def test_card_kernel_matches_plain_on_r5_frames(card, r5_served, batch):
    """The serving problem: 30 keypoints decoded by r5, its selection,
    RANSAC-EPnP's pose and inliers, the network's maps as it returns
    them, 10 LM steps on both candidates."""
    pr = {k: (v if k == 'K' else v[:batch]) for k, v in r5_served.items()}
    kernel_vs_plain(pr, True, f'r5 frames, batch {batch}')


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_card_kernel_matches_plain_vitpose_shaped(card, dtype):
    """ViTPose-H's maps: 128 x 128 at stride 4 of 512 x 512 crops, a view
    of channel-major maps as the model returns them (in f32, and in bf16
    as a model giving bf16 would), read at their strides."""
    pr = to(problems(31, 128, crop=512, stride=4), card)
    hm = pr['heatmaps'].permute(0, 3, 1, 2).contiguous().to(dtype)
    pr['heatmaps'] = hm.permute(0, 2, 3, 1)
    assert not pr['heatmaps'].is_contiguous()
    kernel_vs_plain(pr, True, f'ViTPose-shaped, {dtype}')


@pytest.mark.card
@pytest.mark.parametrize('case', sorted(CASES))
def test_card_kernel_matches_plain_on_other_callers(card, case):
    """The host build's cases with 8 times the problems (the 99% and the
    99th percentile leave room for rounding-level flips)."""
    seed, b, kw, dual = CASES[case]
    kernel_vs_plain(to(problems(seed, 8 * b, **kw), card), dual,
                    f'card {case}')


@pytest.mark.card
def test_card_leading_dims_and_shared_inputs(card):
    """Leading batch dims (2, 48), one keypoint model and one K expanded
    over them (stride 0), no inlier set."""
    pr = to(problems(32, 96, inliers=False, one_model=True), card)
    lead = {k: (v if v is None or k == 'K'
                else v.reshape((2, 48) + v.shape[1:]))
            for k, v in pr.items()}
    lead['points_3d'] = pr['points_3d'][0].expand(2, 48, -1, -1)
    pr['points_3d'] = pr['points_3d'][0].expand(96, -1, -1)
    lead['K'] = pr['K'] = pr['K'][0]
    ref = tpnp.refine_pose_plain(**pr, iters=ITERS)
    got = kmod.refine_pose(**lead, iters=ITERS, return_pick=True)
    got = [x.reshape((96,) + x.shape[2:]) for x in got]
    assert_agree(ref, plain_pick(pr), got[:2], got[2], 'leading dims')


@pytest.mark.card
def test_card_one_launch_per_serving_call(card):
    """One lm_dual launch per serving call: by Graphed.stats() and, in a
    replay of the batch-1 serving graph, one lm_dual_kernel by the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )
    model = load_hrnet_artifact(str(ROOT / 'artifacts' / 'esa_syn_r5.npz'),
                                dtype=torch.bfloat16, device=card)
    pts = synthetic.spacecraft_points(device=card)
    s = synthetic.make_sample(torch.Generator(device=card).manual_seed(2042),
                              pts, 1)
    serve = pipeline.make_jitted_pipeline(model, pts, n_hypotheses=64,
                                          min_keypoints=0)
    serve(s.image, s.bbox)
    before = kmod.refine_pose.launches
    serve(s.image, s.bbox)
    assert kmod.refine_pose.launches - before == 1
    assert serve.graphs.stats()[-1]['launches']['lm_dual'] == 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(s.image, s.bbox)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        pytest.skip('the profiler saw no device time')
    print(f'batch-1 replay: {len(names)} kernels, '
          f'{sum("lm_dual_kernel" in x for x in names)} lm_dual_kernel')
    assert sum('lm_dual_kernel' in x for x in names) == 1


def ransac_fixture_inputs():
    """The RANSAC-EPnP kernel's inputs of its fixture, made on the CPU
    from seeds: the serving problem (30 points, 64 hypotheses of 6), 9
    LINEMOD points with 32, and 4-point samples; projections with pixel
    noise, three gross outliers and a valid mask."""
    out = {}
    for name, seed, n, h, s in (('serving', 41, 30, 64, 6),
                                ('linemod', 42, 9, 32, 6),
                                ('sample_4', 43, 30, 32, 4)):
        rng = np.random.default_rng(seed)
        p3 = rng.uniform(-0.5, 0.5, size=(128, n, 3))
        R = _rotation(rng, 128)
        t = np.stack([rng.uniform(-1, 1, 128), rng.uniform(-1, 1, 128),
                      10.0 + rng.uniform(-2, 2, 128)], -1)
        cam = np.einsum('bij,bnj->bni', R, p3) + t[:, None, :]
        K = camera.SPEED_K
        uv = cam[..., :2] / cam[..., 2:3] * K[[0, 1], [0, 1]] + K[[0, 1],
                                                                  [2, 2]]
        uv += rng.normal(scale=0.7, size=uv.shape)
        uv[:, :3] += rng.uniform(-200, 200, size=(128, 3, 2))
        valid = rng.uniform(size=(128, n)) > 0.15
        u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(seed),
                                      (128,), n, h)
        out[name] = (torch.tensor(p3, dtype=torch.float32),
                     torch.tensor(uv, dtype=torch.float32),
                     torch.tensor(valid), u, s)
    return out


def ransac_fixture_outputs(device):
    """The RANSAC-EPnP kernel's outputs on those inputs, as numpy arrays
    named ``<case>_<output>``."""
    from esa_pose_estimation_tpu_torch.ops.kernels import ransac_epnp as rk
    K = camera.speed_k(device=device)
    out = {}
    for name, (p3, p2, valid, u, s) in ransac_fixture_inputs().items():
        got = rk.ransac_epnp(p3.to(device), p2.to(device), K,
                             valid=valid.to(device), sample_size=s,
                             uniforms=u.to(device), return_chosen=True)
        for key, x in zip(('R', 't', 'inliers', 'cost', 'chosen'), got):
            out[f'{name}_{key}'] = x.cpu().numpy()
    return out


@pytest.mark.card
def test_card_ransac_kernel_unchanged(card):
    """The RANSAC-EPnP kernel, whose LM and mirror now live in shared
    functions, gives bit for bit the outputs it gave before (the fixture,
    written by the kernel as it was, on this card's toolkit)."""
    want = np.load(RANSAC_FIXTURE)
    got = ransac_fixture_outputs(card)
    assert sorted(got) == sorted(want.files)
    for key in want.files:
        assert np.array_equal(got[key], want[key]), key
