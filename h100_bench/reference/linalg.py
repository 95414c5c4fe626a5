"""A frozen copy, for the benchmark's plain reference, of the port's
core/linalg.py.
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

Fixed-iteration small linear algebra for the geometry and solver code.

Port of the JAX package's ``core/linalg.py``.  The algorithms are the same
straight-line programs (no ``torch.linalg.eigh``/``svd``/``cholesky`` in
the hot path): an unrolled Cholesky with a clamped pivot, unrolled
substitution, closed-form 3x3 solves and eigen-solves.  Subtractions run
in the reference's order so that f32 results agree to rounding.

All contractions are plain f32 products; the package turns TF32 off at
import (``esa_pose_estimation_tpu_torch/__init__.py``), which is the
counterpart of the reference pinning ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math

import torch


def _solve3_cramer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 solve (adjugate / det), any number of RHS.

    a: (..., 3, 3); b: (..., 3, k).
    """
    m = [[a[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
    inv_det = 1.0 / det
    adj = [
        [c00, m[0][2] * m[2][1] - m[0][1] * m[2][2],
         m[0][1] * m[1][2] - m[0][2] * m[1][1]],
        [c01, m[0][0] * m[2][2] - m[0][2] * m[2][0],
         m[0][2] * m[1][0] - m[0][0] * m[1][2]],
        [c02, m[0][1] * m[2][0] - m[0][0] * m[2][1],
         m[0][0] * m[1][1] - m[0][1] * m[1][0]],
    ]
    rows = []
    for i in range(3):
        acc = (adj[i][0] * inv_det)[..., None] * b[..., 0, :]
        for j in (1, 2):
            acc = acc + (adj[i][j] * inv_det)[..., None] * b[..., j, :]
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def cholesky_small(a: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky for tiny SPD systems (n <= 16), column by column.

    Pivots are clamped to a tiny positive floor, so a singular or slightly
    indefinite input yields a finite factor instead of NaN: callers that
    solve near-singular systems (RANSAC hypothesis fits, beta refinement)
    reject bad solutions by residual, which needs finite solutions.
    Each entry sees its subtractions in the reference's order (k = 0..j-1).
    """
    n = a.shape[-1]
    L = torch.zeros_like(a)
    for j in range(n):
        s = a[..., j:, j]                            # rows j..n-1 of column j
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j, k, None]
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-25))
        L[..., j, j] = d
        if j + 1 < n:
            L[..., j + 1:, j] = s[..., 1:] * (1.0 / d)[..., None]
    return L


def cho_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` by unrolled forward/back substitution.

    L: (..., n, n) from :func:`cholesky_small`; b: (..., n, k).
    """
    n = L.shape[-1]
    ys: list[torch.Tensor] = []
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * ys[k]
        ys.append(s / L[..., i, i, None])
    xs: list[torch.Tensor | None] = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * xs[k]
        xs[i] = s / L[..., i, i, None]
    return torch.stack(xs, dim=-2)


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 determinant."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def eigvals3_sym(A: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigenvalues of a batched symmetric 3x3, closed form (trig method).

    Returns ``(lmin, lmid, lmax)``, each shaped like ``A[..., 0, 0]``.
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp((B * B).sum((-2, -1)) / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-30)
    # normalize BEFORE the determinant: det(B)/p^3 would flush to 0 in f32
    # for isotropic/zero inputs and turn them into 0/0 = NaN
    r = torch.clamp(_det3(B / safe_p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lmin, 3.0 * q - lmax - lmin, lmax


def smallest_eigvec3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a batched symmetric
    3x3 matrix. (..., 3, 3) -> (..., 3). Branch-free closed form: the null
    space of ``A - lmin I`` read off cross products of its rows, with
    fallbacks for a repeated smallest eigenvalue (rank 1) and for an
    isotropic input (e_x)."""
    lmin, _, lmax = eigvals3_sym(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    scale = torch.clamp(torch.maximum(lmin.abs(), lmax.abs()), min=1e-30)
    C = A - lmin[..., None, None] * eye
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.where((n02 > n01)[..., None], c02, c01)
    bestn = torch.maximum(n01, n02)
    best = torch.where((n12 > bestn)[..., None], c12, best)
    bestn = torch.maximum(bestn, n12)

    rn0 = (r0 * r0).sum(-1)
    rn1 = (r1 * r1).sum(-1)
    rn2 = (r2 * r2).sum(-1)
    u = torch.where((rn1 > rn0)[..., None], r1, r0)
    un = torch.maximum(rn0, rn1)
    u = torch.where((rn2 > un)[..., None], r2, u)
    un = torch.maximum(un, rn2)
    ex = torch.zeros_like(u)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(u)
    ey[..., 1] = 1.0
    axis = torch.where((u[..., 0].abs() ** 2 < 0.8 * un)[..., None], ex, ey)
    plane = torch.linalg.cross(u, axis, dim=-1)

    cross_tol2 = (1e-5 * scale * scale) ** 2
    row_tol2 = (1e-5 * scale) ** 2
    v = torch.where((bestn > cross_tol2)[..., None], best,
                    torch.where((un > row_tol2)[..., None], plane, ex))
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve for batched 3x3 systems (the only size the path uses)."""
    if a.shape[-1] != 3:
        raise ValueError(f'solve supports 3x3 systems only, got {a.shape}')
    return _solve3_cramer(a, b)


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a batched symmetric positive-definite system (n <= 16) via
    :func:`cholesky_small`.  ``b`` may be (..., n) or (..., n, k)."""
    if a.shape[-1] > 16:
        raise ValueError(f'solve_psd supports n <= 16, got {a.shape}')
    L = cholesky_small(a)
    if b.dim() == a.dim() - 1:
        return cho_solve_small(L, b[..., None])[..., 0]
    return cho_solve_small(L, b)
