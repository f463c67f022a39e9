"""Collapsed sparse variational inference with uncertain inputs (port of
``rgp_tpu/inference/collapsed_vi.py``: the bound, the posterior and the
moment-matched predictive).

Bound, with beta = 1/sigma^2, assembled in a detached spectral whitening basis
W of Kmm so every factorized matrix is ~identity-conditioned:

  F0 = -TD/2 log(2 pi sigma^2) - D/2 log|B| - E||Y||^2_F/(2 sigma^2)
       + ||c||^2_F/(2 sigma^4) - D/(2 sigma^2) (Psi0 - tr(Kmm^{-1} Psi2))

Moment-matched prediction at uncertain inputs, with W = (Kmm + beta Psi2)^{-1}
and alpha = beta W Psi1^T Y:

  mu*    = Psi1* alpha
  var*_d = alpha_d^T (Psi2* - Psi1*^T Psi1*) alpha_d
           + Psi0* - tr((Kmm^{-1} - W) Psi2*)  [+ sigma^2]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import Kernel
from ..linalg import cho_solve, hdot, jitchol, log_det_from_chol, solve_triangular
from ..ops.psi_stats import PsiStats, psi01, psi2_per_t
from ..params import positive

__all__ = [
    "collapsed_bound",
    "collapsed_bound_from_suffstats",
    "SparsePosterior",
    "posterior",
    "predict_uncertain",
    "predict_certain",
    "whitening_basis",
    "Whitening",
    "default_spectral_floor",
]

_LOG2PI = 1.8378770664093453  # log(2*pi)


class Whitening(NamedTuple):
    """Detached spectral whitening of Kmm (see :func:`whitening_basis`).

    W: (M, M) ``V diag(lambda_eff^{-1/2})``.
    topup: (M,) ``1 - lambda/lambda_eff``, so that ``W^T Kmm W + diag(topup) = I``
        at the linearization point.
    half_logdet: ``0.5 * sum(log lambda_eff)``.
    """

    W: torch.Tensor
    topup: torch.Tensor
    half_logdet: torch.Tensor


def default_spectral_floor(dtype) -> float:
    """Relative spectral floor, dtype-independent so f32 and f64 evaluate the
    same regularized model."""
    del dtype
    return 1e-6


def _chol_fails(A):
    L, info = torch.linalg.cholesky_ex(A)
    return (info != 0) | torch.isnan(L).any()


def whitening_basis(Kmm, psi2=None, beta=None, spectral_floor: Optional[float] = None):
    """Detached spectral whitening basis for the collapsed bound.

    ``lambda_eff = max(lambda, floor * lambda_max)`` is the softly clamped
    spectrum of Kmm, ``W = V diag(lambda_eff^{-1/2})`` and ``topup = 1 -
    lambda/lambda_eff``. When ``psi2``/``beta`` are given, the floor escalates
    (f0, 1e3 f0, 1e6 f0) until a trial Cholesky of the whitened
    Ct = Kt + beta W^T Psi2 W succeeds. The trial runs in float32 for every
    input dtype, so the regularization is a function of the model and not of
    the evaluation dtype; it is tensor dataflow and never waits for the card.
    """
    Kmm_sym = (0.5 * (Kmm + Kmm.T)).detach()
    if spectral_floor is None:
        spectral_floor = default_spectral_floor(Kmm.dtype)
    lam, V = torch.linalg.eigh(Kmm_sym)  # ascending
    lam_max = torch.clamp(lam[-1], min=1e-30)

    floor = torch.full((), spectral_floor, dtype=Kmm.dtype, device=Kmm.device)
    if psi2 is not None:
        f32 = torch.float32
        p2 = (0.5 * (psi2 + psi2.T)).detach().to(f32)
        K32 = Kmm_sym.to(f32)
        lam32 = lam.to(f32)
        lmax32 = lam_max.to(f32)
        b = torch.as_tensor(beta).detach().to(dtype=f32, device=Kmm.device)
        M = Kmm.shape[-1]
        eye = torch.eye(M, dtype=f32, device=Kmm.device)
        V32 = V.to(f32)

        def _fails(fl):
            lam_eff = torch.maximum(lam32, torch.tensor(fl, dtype=f32) * lmax32)
            W32 = V32 / torch.sqrt(lam_eff)[None, :]
            topup = 1.0 - torch.clamp(lam32, min=0.0) / lam_eff
            Kt = hdot(W32.T, hdot(K32, W32)) + torch.diag(topup)
            At = b * hdot(W32.T, hdot(p2, W32))
            Ct = Kt + 0.5 * (At + At.T)
            Ct = Ct + 1e-6 * torch.diagonal(Ct).mean() * eye
            return _chol_fails(Ct)

        f0 = _fails(spectral_floor)
        f1 = f0 & _fails(1e3 * spectral_floor)
        floor = torch.where(f0, torch.where(f1, 1e6 * floor, 1e3 * floor), floor)

    lam_eff = torch.maximum(lam, floor * lam_max)
    W = V / torch.sqrt(lam_eff)[None, :]
    topup = 1.0 - torch.clamp(lam, min=0.0) / lam_eff
    return Whitening(W.detach(), topup.detach(), (0.5 * torch.log(lam_eff).sum()).detach())


def _common(kern: Kernel, kp, Z, psi2, noise, need_trace: bool = True, W=None,
            psi1_factor=None):
    """Shared whitened factorizations for the collapsed bound:

      Kt = W^T Kmm W + diag(topup),  At = beta W^T Psi2 W,  Ct = Kt + At
      log|B| = log|Ct| - log|Kt|,  tr(Kmm^{-1} Psi2) = tr(Kt^{-1} At)/beta

    The whitened matrices are ~identity-conditioned, so the Cholesky ladder's
    base jitter stays at the dtype's resolution. ``psi1_factor`` (certain
    inputs) forms At from the factor Psi1, PSD by construction."""
    Kmm = kern.K(kp, Z)
    beta = 1.0 / noise
    if W is not None:
        wh = W
    elif psi1_factor is not None:
        wh = whitening_basis(Kmm)
    else:
        wh = whitening_basis(Kmm, psi2, beta)
    W, topup = wh.W, wh.topup
    WtKW = hdot(W.T, hdot(Kmm, W))
    Kt = 0.5 * (WtKW + WtKW.T) + torch.diag(topup)
    if psi1_factor is not None:
        P1W = hdot(psi1_factor, W)  # (T, M)
        At = beta * hdot(P1W.T, P1W)
    else:
        psi2s = 0.5 * (psi2 + psi2.T)
        WtP2W = hdot(W.T, hdot(psi2s, W))
        At = beta * 0.5 * (WtP2W + WtP2W.T)
    Ct = Kt + At
    j0 = 1e-12 if Kmm.dtype == torch.float64 else 1e-6
    Lk = jitchol(Kt, jitter0=j0)
    Lc = jitchol(Ct, jitter0=j0)
    tr_KiP2 = torch.trace(cho_solve(Lk, At)) / beta if need_trace else None
    return Kmm, W, Lk, Lc, tr_KiP2, beta


def collapsed_bound_from_suffstats(kern: Kernel, kp, Z, log_noise, psi0_sum, psi1Y, psi2,
                                   trYY, T, D, *, W: Optional[Whitening] = None,
                                   psi1_factor=None):
    """F0 from the additive sufficient statistics
    (sum_t psi0_t, Psi1^T Y, sum_t Psi2_t, E||Y||^2, T)."""
    noise = positive(log_noise)
    _, W, Lk, Lc, tr_KmmInvPsi2, beta = _common(
        kern, kp, Z, psi2, noise, W=W, psi1_factor=psi1_factor
    )
    c = solve_triangular(Lc, hdot(W.T, psi1Y))
    log_det_B = log_det_from_chol(Lc) - log_det_from_chol(Lk)
    return (
        -0.5 * T * D * (_LOG2PI + torch.log(noise))
        - 0.5 * D * log_det_B
        - 0.5 * beta * trYY
        + 0.5 * beta * beta * (c * c).sum()
        - 0.5 * D * beta * (psi0_sum - tr_KmmInvPsi2)
    )


def collapsed_bound(kern: Kernel, kp, Z, log_noise, stats: PsiStats, Y, Y_var=None, *,
                    W: Optional[Whitening] = None, certain: bool = False):
    """The collapsed bound F0. ``Y`` are target means (T, D); ``Y_var``
    optional target variances for variational (hidden-layer) targets."""
    T, D = Y.shape
    psi1Y = hdot(stats.psi1.T, Y)  # (M, D)
    trYY = (Y * Y).sum()
    if Y_var is not None:
        trYY = trYY + Y_var.sum()
    return collapsed_bound_from_suffstats(
        kern, kp, Z, log_noise, stats.psi0.sum(), psi1Y, stats.psi2, trYY, T, D,
        W=W, psi1_factor=stats.psi1 if certain else None,
    )


class SparsePosterior(NamedTuple):
    """alpha: (M, D) beta W Psi1^T Y; woodbury_inv: (M, M) Kmm^{-1} - W;
    W: (M, M) (Kmm + beta Psi2)^{-1}."""

    alpha: torch.Tensor
    woodbury_inv: torch.Tensor
    W: torch.Tensor


def posterior(kern: Kernel, kp, Z, log_noise, stats: PsiStats, Y, *,
              certain: bool = False) -> SparsePosterior:
    """Sufficient statistics of q(u) for prediction, through the same
    whitened factorization as the bound."""
    noise = positive(log_noise)
    _, Wb, Lk, Lc, _, beta = _common(
        kern, kp, Z, stats.psi2, noise, need_trace=False,
        psi1_factor=stats.psi1 if certain else None,
    )
    psi1Y = hdot(stats.psi1.T, Y)
    alpha = beta * hdot(Wb, cho_solve(Lc, hdot(Wb.T, psi1Y)))
    Rc = solve_triangular(Lc, Wb.T)
    Rk = solve_triangular(Lk, Wb.T)
    C_inv = hdot(Rc.T, Rc)
    Kmm_inv = hdot(Rk.T, Rk)
    return SparsePosterior(alpha=alpha, woodbury_inv=Kmm_inv - C_inv, W=C_inv)


def predict_certain(kern: Kernel, kp, Z, log_noise, post: SparsePosterior, Xs, *,
                    full_cov: bool = False, include_noise: bool = False):
    """Sparse-posterior predictive at certain inputs Xs: mean = Kxz alpha,
    cov = Kxx - Kxz (Kmm^{-1} - W) Kzx."""
    noise = positive(log_noise)
    Kxz = kern.K(kp, Xs, Z)
    mean = hdot(Kxz, post.alpha)
    if full_cov:
        cov = kern.K(kp, Xs) - hdot(Kxz, hdot(post.woodbury_inv, Kxz.T))
        if include_noise:
            cov = cov + noise * torch.eye(Xs.shape[0], dtype=cov.dtype, device=cov.device)
        return mean, cov
    var = kern.Kdiag(kp, Xs) - torch.einsum("tm,mn,tn->t", Kxz, post.woodbury_inv, Kxz)
    var = torch.clamp(var, min=1e-12)[:, None]
    if include_noise:
        var = var + noise
    return mean, var.expand(mean.shape)


def predict_uncertain(kern: Kernel, kp, Z, log_noise, post: SparsePosterior, mu_star,
                      s_star=None, *, include_noise: bool = False):
    """Moment-matched predictive at q(x*) = N(mu*, diag(s*)) (batch over rows).
    Returns (mean (T*, D), var (T*, D))."""
    noise = positive(log_noise)
    psi0, psi1 = psi01(kern, kp, Z, mu_star, s_star)
    p2t = psi2_per_t(kern, kp, Z, mu_star, s_star)  # (T*, M, M)
    mean = hdot(psi1, post.alpha)  # (T*, D)
    quad = torch.einsum("md,tmn,nd->td", post.alpha, p2t, post.alpha)
    trace_term = torch.einsum("mn,tnm->t", post.woodbury_inv, p2t)  # (T*,)
    var = quad - mean * mean + (psi0 - trace_term)[:, None]
    if include_noise:
        var = var + noise
    var = torch.clamp(var, min=1e-12)
    return mean, var
