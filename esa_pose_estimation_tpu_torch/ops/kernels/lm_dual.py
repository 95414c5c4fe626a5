"""The serving path's final refinement on Hopper: ``ops/pnp.refine_pose``
(the refine stage's weights, the mirror pose, LM on both, the heatmap
evidence and the choice) in one launch.

Replaces no TPU kernel: the JAX refinement (``esa_pose_estimation_tpu/ops/
pnp.py`` ``lm_refine_dual``, ``heatmap_evidence``) is jnp under ``jit``,
which XLA fuses.  The CUDA source is ``csrc/lm_dual.cu`` (the arithmetic
in ``csrc/lm_dual.cuh`` and ``csrc/ransac_epnp.cuh``); the plain PyTorch
version is ``ops/pnp.refine_pose_plain``, which on the card is ~2,000
kernels of a few scalars each and a permuted f32 copy of the heatmaps.

Bound on the card: the dependent chain of one problem (ten 6x6 solves in
a row), not bytes (~1.5 KB and 240 heatmap taps a problem) nor operations
(~0.1 MFLOP a problem).  The kernel runs one CTA per problem and one warp
per candidate, the lanes owning the points; the mirror's Kabsch fit runs
on one lane while the other warp starts; the heatmaps are read where they
lie, in their own dtype and strides.
"""

from __future__ import annotations

import ctypes

import torch

from esa_pose_estimation_tpu_torch import _build
from esa_pose_estimation_tpu_torch.ops.kernels.ransac_epnp import _rows

# Mirrors of csrc/lm_dual.cu and .cuh (tests/test_torch_lm_dual_kernel.py
# checks them).
_MAX_POINTS = 64          # kMaxPoints
_MAX_CANDIDATES = 2       # kMaxCandidates
_ERRORS = {-1: 'a size outside what the kernel takes (points, LM '
               'iterations, candidates, heatmap side or batch)'}
_HEATMAP_DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load('lm_dual').lm_dual_launch
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, P, L, P, L, P, L, P, L, P, L, P, L, P, L,
                       P, I, L, L, L, L, I, P, L, P, L, L, I, I, I,
                       P, P, P, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def refine_pose(points_3d: torch.Tensor, points_2d: torch.Tensor,
                confidences: torch.Tensor, K: torch.Tensor,
                R0: torch.Tensor, t0: torch.Tensor, iters: int = 20,
                disambiguate: bool = True,
                select: torch.Tensor | None = None,
                inliers: torch.Tensor | None = None,
                heatmaps: torch.Tensor | None = None,
                rates: torch.Tensor | None = None,
                origins: torch.Tensor | None = None,
                return_pick: bool = False):
    """:func:`ops.pnp.refine_pose` on CUDA tensors, one launch.  Returns
    (R (..., 3, 3), t (..., 3)), and with ``return_pick`` the candidate
    kept (..., ) uint8 (0 the pose, 1 its mirror), for checking.

    Takes f32 points_3d (..., N, 3) with N <= 64, points_2d (..., N, 2),
    confidences (..., N), K (3, 3) or per problem, R0 (..., 3, 3), t0
    (..., 3); select and inliers (..., N) bool or None; heatmaps (..., S,
    S, N) f32 or bf16 at any strides, with rates (...,) f32 and the crops'
    int32 origins (..., 2), or None.  Raises on anything else, before any
    launch."""
    if points_3d.dim() < 2 or points_3d.shape[-1] != 3:
        raise ValueError(f'points_3d must be (..., N, 3), got '
                         f'{tuple(points_3d.shape)}')
    batch = tuple(points_3d.shape[:-2])
    n = points_3d.shape[-2]
    shapes = {'points_2d': (points_2d, batch + (n, 2)),
              'confidences': (confidences, batch + (n,)),
              'R0': (R0, batch + (3, 3)), 't0': (t0, batch + (3,)),
              'select': (select, batch + (n,)),
              'inliers': (inliers, batch + (n,))}
    if heatmaps is not None:
        s = heatmaps.shape[-2] if heatmaps.dim() >= 3 else -1
        shapes.update(heatmaps=(heatmaps, batch + (s, s, n)),
                      rates=(rates, batch), origins=(origins, batch + (2,)))
    for name, (x, want) in shapes.items():
        if x is not None and tuple(x.shape) != want:
            raise ValueError(f'lm_dual kernel: {name} must be {want}, got '
                             f'{tuple(x.shape)}')
    if heatmaps is not None and (rates is None or origins is None):
        raise ValueError('lm_dual kernel: heatmaps need rates and origins')
    if K.shape[-2:] != (3, 3):
        raise ValueError(f'K must be (3, 3) or (..., 3, 3), got '
                         f'{tuple(K.shape)}')
    for name, x in (('points_3d', points_3d), ('points_2d', points_2d),
                    ('confidences', confidences), ('K', K), ('R0', R0),
                    ('t0', t0), ('rates', rates)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f'lm_dual kernel: {name} must be float32, got '
                            f'{x.dtype}')
    for name, x in (('select', select), ('inliers', inliers)):
        if x is not None and x.dtype != torch.bool:
            raise TypeError(f'lm_dual kernel: {name} must be bool, got '
                            f'{x.dtype}')
    if heatmaps is not None and heatmaps.dtype not in _HEATMAP_DTYPES:
        raise TypeError(f'lm_dual kernel: heatmaps must be float32 or '
                        f'bfloat16, got {heatmaps.dtype}')
    if origins is not None and origins.dtype != torch.int32:
        raise TypeError(f'lm_dual kernel: origins must be int32, got '
                        f'{origins.dtype}')
    if not 1 <= n <= _MAX_POINTS:
        raise ValueError(f'lm_dual kernel: 1 to {_MAX_POINTS} points a '
                         f'problem, got {n}')
    if iters < 0:
        raise ValueError(f'lm_dual kernel: iters {iters} must be >= 0')
    dev = points_3d.device
    for name, x in (('points_2d', points_2d), ('confidences', confidences),
                    ('K', K), ('R0', R0), ('t0', t0), ('select', select),
                    ('inliers', inliers), ('heatmaps', heatmaps),
                    ('rates', rates), ('origins', origins)):
        if x is not None and x.device != dev:
            raise RuntimeError(f'lm_dual kernel: {name} is on {x.device}, '
                               f'points_3d on {dev}')
    if dev.type != 'cuda':
        raise RuntimeError(f'lm_dual kernel: CUDA tensors expected, got '
                           f'{dev}')

    p3, s3 = _rows(points_3d, batch, (n, 3))
    p2, s2 = _rows(points_2d, batch, (n, 2))
    k, sk = _rows(K, batch, (3, 3))
    conf, sc = _rows(confidences, batch, (n,))
    r0, sr = _rows(R0, batch, (3, 3))
    t0_, st = _rows(t0, batch, (3,))
    sel, ss = (None, 0) if select is None else _rows(select, batch, (n,))
    inl, si = (None, 0) if inliers is None else _rows(inliers, batch, (n,))
    hm = None
    hm_strides = (0, 0, 0, 0)
    side = rate_stride = org_stride = 0
    if heatmaps is not None:
        side = heatmaps.shape[-2]
        # the maps are read where they lie: a view over the batch, no copy
        hm = heatmaps.reshape((-1, side, side, n))
        hm_strides = tuple(hm.stride())
        rates, rate_stride = _rows(rates, batch, ())
        origins, org_stride = _rows(origins, batch, (2,))
    b = p3.shape[0]
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    picked = (torch.empty((b,), dtype=torch.uint8, device=dev)
              if return_pick else None)
    if b > 0:
        # the launch goes to the runtime's current card: make it the inputs'
        with torch.cuda.device(dev):
            err = _entry()(
                p3.data_ptr(), s3, p2.data_ptr(), s2, k.data_ptr(), sk,
                conf.data_ptr(), sc, None if sel is None else sel.data_ptr(),
                ss, None if inl is None else inl.data_ptr(), si,
                r0.data_ptr(), sr, t0_.data_ptr(), st,
                None if hm is None else hm.data_ptr(),
                int(hm is not None and hm.dtype == torch.bfloat16),
                *hm_strides, side,
                None if hm is None else rates.data_ptr(), rate_stride,
                None if hm is None else origins.data_ptr(), org_stride, b, n, iters, 2 if disambiguate else 1,
                R.data_ptr(), t.data_ptr(),
                None if picked is None else picked.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, f'lm_dual on {dev}', _ERRORS)
        refine_pose.launches += 1
    out = (R.reshape(batch + (3, 3)), t.reshape(batch + (3,)))
    return out + (picked.reshape(batch),) if return_pick else out


refine_pose.launches = 0
