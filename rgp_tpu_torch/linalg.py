"""Dense linear algebra for GP inference (port of ``rgp_tpu/linalg.py``).

Numerics policy: GP bounds are far too ill-conditioned for TF32, so TF32 is
pinned off for CUDA matmuls and cuDNN at import (the JAX package's
``precision=HIGHEST``). ``jitchol`` keeps the reference's straight-line jitter
ladder as pure tensor dataflow: no ``.item()`` and no Python branch on a device
value, so it never waits for the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "hdot",
    "tdot",
    "jitchol",
    "jitchol_with_jitter",
    "solve_triangular",
    "cho_solve",
    "backsub_both_sides",
    "pdinv",
    "log_det_from_chol",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def hdot(a, b):
    """Full-precision matmul (TF32 is off, see the module note)."""
    return torch.matmul(a, b)


def tdot(a):
    """A @ A^T (reference ``tdot``, i.e. dsyrk)."""
    return torch.matmul(a, a.mT)


def _add_jitter(A, jitter):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A + jitter[..., None, None] * eye


def _cholesky_or_nan(A):
    """Lower Cholesky factor and a failure flag.

    On failure XLA returns a factor whose lower triangle is all NaN,
    ``torch.linalg.cholesky`` raises and ``cholesky_ex`` leaves a partial
    factor; this reproduces XLA. A failure is ``info != 0`` or a NaN anywhere
    in the factor (NaN input).
    """
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info != 0) | torch.isnan(L).any(dim=(-2, -1))
    L = torch.where(failed[..., None, None], torch.full_like(L, float("nan")).tril(), L)
    return L, failed


def jitchol_with_jitter(A, jitter0: float = 1e-6):
    """Cholesky with the reference's straight-line 4-rung jitter escalation
    (``rgp_tpu/linalg.py:60-115``): trial factorizations at x1 and x1e3 of
    ``jitter0 * mean(diag A)`` choose the rung (x1, x1e3 or a blind x1e7), then
    ONE factorization runs at that rung. The rung choice is detached; the
    diag-mean scale stays differentiable. A failed final factorization has an
    all-NaN lower triangle, as in XLA. Returns ``(L, absolute_jitter)``."""
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)
    scale = torch.clamp(diag_mean, min=1e-30)
    A_sg = A.detach()
    j0 = jitter0 * scale.detach()
    f0 = _cholesky_or_nan(_add_jitter(A_sg, j0))[1]
    f1 = f0 & _cholesky_or_nan(_add_jitter(A_sg, 1e3 * j0))[1]
    rel = torch.where(
        f1,
        torch.full_like(scale, 1e7 * jitter0),
        torch.where(f0, torch.full_like(scale, 1e3 * jitter0), torch.full_like(scale, jitter0)),
    ).detach()
    jitter = rel * scale
    L = _cholesky_or_nan(_add_jitter(A, jitter))[0]
    return L, jitter


def jitchol(A, jitter0: float = 1e-6):
    """Lower Cholesky factor of A + jitter*I (see :func:`jitchol_with_jitter`)."""
    return jitchol_with_jitter(A, jitter0=jitter0)[0]


def solve_triangular(L, B, *, lower: bool = True, trans: bool = False):
    """Solves op(L) X = B; ``trans=True`` solves L^T X = B."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower, left=True)
    return torch.linalg.solve_triangular(L, B, upper=not lower, left=True)


def cho_solve(L, B):
    """Solve A X = B given L = chol(A)."""
    y = solve_triangular(L, B, lower=True, trans=False)
    return solve_triangular(L, y, lower=True, trans=True)


def backsub_both_sides(L, X, transpose: str = "left"):
    """Congruence by L^{-1} (reference ``backsub_both_sides``):
    ``transpose='left'`` gives L^{-T} X L^{-1}, ``'right'`` L^{-1} X L^{-T}."""
    if transpose not in ("left", "right"):
        raise ValueError(f"transpose must be 'left' or 'right', got {transpose!r}")
    trans = transpose == "left"
    tmp = solve_triangular(L, X, lower=True, trans=trans)
    return solve_triangular(L, tmp.mT, lower=True, trans=trans).mT


def pdinv(A, jitter0: float = 1e-6):
    """Inverse of a PD matrix through :func:`jitchol` (reference ``pdinv``).
    Returns (Ainv, L, half_logdet)."""
    L = jitchol(A, jitter0=jitter0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    Ainv = cho_solve(L, eye)
    half_logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return Ainv, L, half_logdet


def log_det_from_chol(L):
    """log|A| from L = chol(A)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
