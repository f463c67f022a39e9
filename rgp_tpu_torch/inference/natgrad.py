"""Natural-gradient updates of the Gaussian q(u) block (port of
``rgp_tpu/inference/natgrad.py``; config 4).

For q(u) = N(m, S) per output dimension, a step of size gamma in the natural
parameters theta = (S^{-1} m, -1/2 S^{-1}) along dL/d eta, the gradient with
respect to the expectation parameters eta = (m, S + m m^T), is the natural
gradient (Salimbeni, Eleftheriadis & Hensman 2018). The ELBO is re-expressed
as a function of (eta1, eta2) with m = eta1 and S = eta2 - eta1 eta1^T;
autograd gives dL/d eta; theta moves; the result goes back to (m, chol(S)).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..linalg import _cholesky_or_nan, cho_solve, jitchol
from ..params import leaves_with_paths, positive_inv, with_leaves
from .svi import qu_moments

__all__ = ["natgrad_step"]

_DIAG_FLOOR = torch.tensor(1e-10, dtype=torch.float64)  # a CPU scalar: no fill launch


def _qu_from_mS(m, S, template):
    """The unconstrained q(u) tree from its moments (inverse of
    :func:`qu_moments`). ``template`` is accepted for the JAX signature."""
    del template
    L = jitchol(S, jitter0=1e-8)  # (D, M, M)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)  # (D, M)
    return {
        "m": m,
        "log_diag": positive_inv(torch.maximum(diag, _DIAG_FLOOR)),
        "tril": torch.tril(L, diagonal=-1),
    }


def natgrad_step(elbo_of_qu: Callable, qu, lr: float):
    """One natural-gradient ascent step on q(u); returns the updated tree.

    ``elbo_of_qu(qu) -> scalar`` must not need gradients of anything but its
    argument: its other inputs should be detached, so that autograd builds no
    graph through them. Only ``eta1`` and ``eta2`` require grad.

    The step is guarded as in the JAX package: the candidates at lr/16, lr/4
    and lr are all evaluated, each converted back through a raw Cholesky of
    the new precision (a failure gives NaN, as in XLA), and the largest whose
    every entry is finite is kept, else q(u) stays. The choice is a
    ``torch.where`` on a device boolean: no host read, no early exit.
    """
    with torch.no_grad():
        m, S, _ = qu_moments(qu)  # m (M, D), S (D, M, M)
        mT = m.T  # (D, M)
        eta1 = mT.clone()
        eta2 = S + torch.einsum("di,dj->dij", mT, mT)
    eta1.requires_grad_(True)
    eta2.requires_grad_(True)
    with torch.enable_grad():
        m_ = eta1.T
        S_ = eta2 - torch.einsum("di,dj->dij", eta1, eta1)
        g1, g2 = torch.autograd.grad(elbo_of_qu(_qu_from_mS(m_, S_, qu)), (eta1, eta2))

    with torch.no_grad():
        g2 = 0.5 * (g2 + g2.mT)
        eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device).expand(S.shape)
        LS = jitchol(S, jitter0=1e-8)
        Sinv = cho_solve(LS, eye)
        theta1 = torch.einsum("dij,dj->di", Sinv, mT)  # S^{-1} m
        theta2 = -0.5 * Sinv

        def step_at(scale):
            """Candidate at step size scale*lr: (qu', every entry finite)."""
            t1 = theta1 + scale * lr * g1
            t2 = theta2 + scale * lr * g2
            # back to moments: S = (-2 theta2)^{-1}, m = S theta1; the
            # precision must stay PD, and a raw Cholesky (no jitter rescue)
            # makes a violation show as NaN instead of a silent garbage step
            LP = _cholesky_or_nan(-2.0 * t2)[0]
            S_new = cho_solve(LP, eye)
            S_new = 0.5 * (S_new + S_new.mT)
            m_new = torch.einsum("dij,dj->di", S_new, t1).T  # (M, D)
            cand = _qu_from_mS(m_new, S_new, qu)
            ok = torch.stack([torch.isfinite(x).all() for _, x in leaves_with_paths(cand)]).all()
            return cand, ok

        # a full step can push the precision indefinite in float32 late in
        # training: backtrack lr -> lr/4 -> lr/16, else no update, so every
        # branch is finite. The largest valid step wins.
        out = [x for _, x in leaves_with_paths(qu)]
        for scale in (1.0 / 16.0, 1.0 / 4.0, 1.0):
            cand, ok = step_at(scale)
            out = [torch.where(ok, new, old) for (_, new), old in zip(leaves_with_paths(cand), out)]
        return with_leaves(qu, out)
