"""RANSAC-EPnP on Hopper: the whole of ``ops/pnp.ransac_epnp`` in one
launch.

Replaces no TPU kernel: the JAX solver (``esa_pose_estimation_tpu/ops/
pnp.py`` ``ransac_epnp``) is jnp under ``jit``, which XLA fuses.  The CUDA
source is ``csrc/ransac_epnp.cu`` (the arithmetic in
``csrc/ransac_epnp.cuh``); the plain PyTorch version is
``ops/pnp.ransac_epnp_plain``, which on the card is ~7,300 kernels of a few
scalars each.

Bound on the card: the dependent chain of one problem (Cholesky,
substitutions, beta and LM steps), not bytes (~8 KB a problem) nor
operations (~0.7 MFLOP a problem).  The kernel runs one CTA per problem
with the problem in shared memory, one thread per hypothesis with its
12x12 system in registers, the choice as a warp reduction, the refit's
M^T M over 78 threads and its solve on one, and the LM on one warp whose
lanes own the points.  :func:`block_threads` mirrors how the ``.cu`` sizes
the launch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from esa_pose_estimation_tpu_torch import _build

# Mirrors of csrc/ransac_epnp.cu and .cuh (tests/test_torch_ransac_kernel.py
# checks them).
_MAX_POINTS = 64          # kMaxPoints
_MAX_THREADS = 256        # kMaxThreads
_MIN_THREADS = 96         # kMinThreads
_ERRORS = {-1: 'a size outside what the kernel takes (points, hypotheses, '
               'sample size, LM iterations or batch)'}


def block_threads(n_hyp: int) -> int:
    """Threads per CTA for ``n_hyp`` hypotheses: a warp multiple, from
    ``_MIN_THREADS`` (the refit sums 78 entries of M^T M side by side) to
    ``_MAX_THREADS`` (the block strides over more hypotheses)."""
    t = -(-n_hyp // 32) * 32
    return min(max(t, _MIN_THREADS), _MAX_THREADS)


@lru_cache(maxsize=8)
def _bases(device: torch.device) -> torch.Tensor:
    """The plain version's start bases of the inverse iteration, 12 x 1
    then 12 x 4 row-major, on ``device``, copied once."""
    from esa_pose_estimation_tpu_torch.ops.epnp import _start_basis_tensor
    return torch.cat([
        _start_basis_tensor(12, k, torch.float32, device).reshape(-1)
        for k in (1, 4)]).contiguous()


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load('ransac_epnp').ransac_epnp_launch
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, P, L, P, L, P, L, P, L, I, P, L, I, I, I, I, I,
                       ctypes.c_float, ctypes.c_float, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows(x: torch.Tensor, batch: tuple, inner: tuple
          ) -> tuple[torch.Tensor, int]:
    """``x`` broadcast to ``batch + inner`` as (B,) + inner rows whose
    inner part is contiguous, and the stride between rows (0 where every
    row is the same memory: a (3, 3) K, an expanded keypoint model)."""
    x = x.expand(batch + inner).reshape((-1,) + inner)
    if x.shape[0] and not x[0].is_contiguous():
        x = x.contiguous()
    return x, (x.stride(0) if x.shape[0] > 1 else 0)


def ransac_epnp(points_3d: torch.Tensor, points_2d: torch.Tensor,
                K: torch.Tensor, generator: torch.Generator | None = None,
                valid: torch.Tensor | None = None,
                reproj_threshold: float = 5.0, n_hypotheses: int = 64,
                sample_size: int = 6, lm_iters: int = 10,
                masks: torch.Tensor | None = None,
                uniforms: torch.Tensor | None = None,
                return_chosen: bool = False):
    """:func:`ops.pnp.ransac_epnp` on CUDA tensors, one launch.  Returns
    (R (..., 3, 3), t (..., 3), inliers (..., N) bool, cost (...,)), and
    with ``return_chosen`` the best hypothesis's inliers (..., N) bool,
    for checking.

    Takes f32 points_3d (..., N, 3) with N <= 64, points_2d (..., N, 2),
    K (3, 3) or per problem, valid (..., N) bool or None, and ``masks``
    (..., H, N) or ``uniforms`` (..., H, N) f32 or neither (then drawn
    from ``generator`` as the plain version draws them).  Raises on
    anything else, before any launch."""
    if points_3d.dim() < 2 or points_3d.shape[-1] != 3:
        raise ValueError(f'points_3d must be (..., N, 3), got '
                         f'{tuple(points_3d.shape)}')
    batch = tuple(points_3d.shape[:-2])
    n = points_3d.shape[-2]
    if tuple(points_2d.shape) != batch + (n, 2):
        raise ValueError(f'points_2d must be {batch + (n, 2)}, got '
                         f'{tuple(points_2d.shape)}')
    if K.shape[-2:] != (3, 3):
        raise ValueError(f'K must be (3, 3) or (..., 3, 3), got '
                         f'{tuple(K.shape)}')
    for name, x in (('points_3d', points_3d), ('points_2d', points_2d),
                    ('K', K), ('uniforms', uniforms)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f'ransac_epnp kernel: {name} must be float32, '
                            f'got {x.dtype}')
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError(f'ransac_epnp kernel: valid must be bool, got '
                        f'{valid.dtype}')
    if not 1 <= n <= _MAX_POINTS:
        raise ValueError(f'ransac_epnp kernel: 1 to {_MAX_POINTS} points a '
                         f'problem, got {n}')
    sample_size = min(sample_size, n)
    if sample_size < 1 or lm_iters < 0:
        raise ValueError(f'ransac_epnp kernel: sample_size {sample_size} '
                         f'and lm_iters {lm_iters} must be >= 1 and >= 0')
    samples = masks if masks is not None else uniforms
    if samples is not None and (samples.dim() < 2 or samples.shape[-1] != n
                                or samples.shape[-2] < 1):
        raise ValueError(f'masks or uniforms must be (..., H, {n}) with '
                         f'H >= 1, got {tuple(samples.shape)}')
    dev = points_3d.device
    for name, x in (('points_2d', points_2d), ('K', K), ('valid', valid),
                    ('masks', masks), ('uniforms', uniforms)):
        if x is not None and x.device != dev:
            raise RuntimeError(f'ransac_epnp kernel: {name} is on '
                               f'{x.device}, points_3d on {dev}')
    if dev.type != 'cuda':
        raise RuntimeError(f'ransac_epnp kernel: CUDA tensors expected, got '
                           f'{dev}')

    if samples is None:
        from esa_pose_estimation_tpu_torch.ops.pnp import draw_ransac_uniforms
        samples = draw_ransac_uniforms(generator, batch, n, n_hypotheses, dev)
    n_hyp = samples.shape[-2]
    p3, s3 = _rows(points_3d, batch, (n, 3))
    p2, s2 = _rows(points_2d, batch, (n, 2))
    k, sk = _rows(K, batch, (3, 3))
    v, sv = (None, 0) if valid is None else _rows(valid, batch, (n,))
    smp, ss = _rows(samples.to(torch.float32), batch, (n_hyp, n))
    b = p3.shape[0]
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    inliers = torch.empty((b, n), dtype=torch.bool, device=dev)
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    chosen = (torch.empty((b, n), dtype=torch.bool, device=dev)
              if return_chosen else None)
    if b > 0:
        # the launch goes to the runtime's current card: make it the inputs'
        with torch.cuda.device(dev):
            err = _entry()(
                p3.data_ptr(), s3, p2.data_ptr(), s2, k.data_ptr(), sk,
                None if v is None else v.data_ptr(), sv, smp.data_ptr(), ss,
                int(masks is not None), _bases(dev).data_ptr(), b, n, n_hyp,
                sample_size, lm_iters, int(sample_size < 6),
                float(reproj_threshold), float(reproj_threshold * 4.0),
                R.data_ptr(), t.data_ptr(), inliers.data_ptr(),
                cost.data_ptr(), None if chosen is None else chosen.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, f'ransac_epnp on {dev}', _ERRORS)
        ransac_epnp.launches += 1
    out = (R.reshape(batch + (3, 3)), t.reshape(batch + (3,)),
           inliers.reshape(batch + (n,)), cost.reshape(batch))
    return out + (chosen.reshape(batch + (n,)),) if return_chosen else out


ransac_epnp.launches = 0
