"""Stochastic (uncollapsed) sparse variational inference with an explicit
q(u) (port of ``rgp_tpu/inference/svi.py``; config 4).

q(u) = N(m, S) per output dimension, so the bound decomposes over datapoints
and supports minibatches and natural-gradient updates. Per batch, with
w = T_total / |batch| and certain inputs as s = 0:

  ELBO = w * sum_{t in batch} E_q(x_t) E_q(u) [ log N(y_t | f_t, sigma^2) ]
         - KL(q(u) || N(0, Kmm))

Every per-t quantity reduces through the additive statistics (Psi0 sum,
Psi1^T y, Psi2 sum), so one ``PsiStats`` per batch suffices. The bound and
the predictive are assembled in the same detached spectral whitening basis
as the collapsed bound (:func:`rgp_tpu_torch.inference.collapsed_vi.whitening_basis`).

S_d = L_d L_d^T with L_d lower triangular, its diagonal softplus-positive
(stored unconstrained in ``log_diag``), its strict lower triangle in ``tril``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import Kernel
from ..linalg import cho_solve, hdot, jitchol, log_det_from_chol, solve_triangular
from ..ops.psi_stats import PsiStats, psi01, psi2_per_t
from ..params import positive
from .collapsed_vi import Whitening, whitening_basis

__all__ = ["init_qu", "qu_moments", "svi_bound", "svi_predict", "QuPredictor", "qu_predictor",
           "predict_from"]

_LOG2PI = 1.8378770664093453  # log(2*pi)
_VAR_FLOOR = torch.tensor(1e-12, dtype=torch.float64)  # a CPU scalar: no fill launch


def init_qu(M: int, D: int, *, init_scale: float = 0.1, dtype=torch.float32, device=None):
    """q(u)'s parameters: means ``m`` (M, D), the unconstrained diagonal
    ``log_diag`` (D, M) of S's Cholesky factor and its strict lower triangle
    ``tril`` (D, M, M). ``device=None`` means the card."""
    dev = resolve_device(device)
    raw = np.log(np.expm1(init_scale))
    return {
        "m": torch.zeros((M, D), dtype=dtype, device=dev),
        "log_diag": torch.full((D, M), float(raw), dtype=dtype, device=dev),
        "tril": torch.zeros((D, M, M), dtype=dtype, device=dev),
    }


def qu_moments(qu):
    """-> (m (M, D), S (D, M, M), L_S (D, M, M))."""
    m = qu["m"]
    L = torch.tril(qu["tril"], diagonal=-1) + torch.diag_embed(positive(qu["log_diag"]))
    S = torch.einsum("dij,dkj->dik", L, L)
    return m, S, L


def _whitened_kmm(Kmm, wh: Whitening):
    """chol(Kt), Kt = W^T Kmm W + diag(topup) (~ I), with the jitter ladder's
    base at the dtype's resolution."""
    Wb = wh.W
    WtKW = hdot(Wb.T, hdot(Kmm, Wb))
    Kt = 0.5 * (WtKW + WtKW.T) + torch.diag(wh.topup)
    j0 = 1e-12 if Kmm.dtype == torch.float64 else 1e-6
    return jitchol(Kt, jitter0=j0)


def svi_bound(kern: Kernel, kp, Z, log_noise, qu, stats: PsiStats, Y, *,
              T_total: Optional[int] = None, Y_var=None, jitter: Optional[float] = None):
    """Minibatch ELBO. ``stats`` are the psi statistics of the batch inputs,
    ``Y`` (B, D) the batch targets (variational with ``Y_var``). ``jitter`` is
    accepted for the JAX signature and unused, as there."""
    del jitter
    B, D = Y.shape
    if T_total is None:
        T_total = B
    w = T_total / B
    noise = positive(log_noise)
    beta = 1.0 / noise

    Kmm = kern.K(kp, Z)
    wh = whitening_basis(Kmm, stats.psi2, beta)
    Wb = wh.W
    Lk = _whitened_kmm(Kmm, wh)

    m, S, L_S = qu_moments(qu)
    at = cho_solve(Lk, hdot(Wb.T, m))  # Kt^{-1} W^T m
    a = hdot(Wb, at)  # Kmm_reg^{-1} m, (M, D)

    psi1Y = hdot(stats.psi1.T, Y)  # (M, D)
    psi0_sum = stats.psi0.sum()
    psi2s = 0.5 * (stats.psi2 + stats.psi2.T)
    P2t = hdot(Wb.T, hdot(psi2s, Wb))  # whitened Psi2
    KiP2t = cho_solve(Lk, P2t)  # Kt^{-1} P2t
    tr_KiP2 = torch.trace(KiP2t)
    G = cho_solve(Lk, KiP2t.T).T  # Kt^{-1} P2t Kt^{-1}
    St = torch.einsum("im,dij,jn->dmn", Wb, S, Wb)  # whitened S, (D, M, M)

    # sum_t E[(y_t - f_t)^2] over the batch, all outputs
    trYY = (Y * Y).sum()
    if Y_var is not None:
        trYY = trYY + Y_var.sum()
    cross = -2.0 * (psi1Y * a).sum()
    quad_m = torch.einsum("md,mn,nd->", a, psi2s, a)
    quad_S = torch.einsum("dij,ij->", St, G)
    sq_err = trYY + cross + quad_m + quad_S + D * (psi0_sum - tr_KiP2)

    data_term = w * (-0.5 * B * D * (_LOG2PI + torch.log(noise)) - 0.5 * beta * sq_err)

    # KL(q(u) || N(0, Kmm_reg)) over output dims; log|Kt| (0 at the
    # linearization point) is the differentiable correction on top of the
    # detached half log-det of the regularized spectrum
    M_ = Z.shape[0]
    mKm = (m * a).sum()
    eye = torch.eye(M_, dtype=m.dtype, device=m.device)
    tr_KiS = torch.einsum("dij,ij->", St, cho_solve(Lk, eye))
    logdet_S = 2.0 * torch.log(torch.abs(torch.diagonal(L_S, dim1=-2, dim2=-1))).sum()
    logdet_K = 2.0 * wh.half_logdet + log_det_from_chol(Lk)
    kl = 0.5 * (tr_KiS + mKm - M_ * D + D * logdet_K - logdet_S)

    return data_term - kl


class QuPredictor(NamedTuple):
    """What the SVI predictive needs that does not depend on the query point:
    a = Kmm_reg^{-1} m (M, D), Ki = Kmm_reg^{-1} (M, M), KiSKi = Ki S_d Ki
    (D, M, M), and the noise variance."""

    a: torch.Tensor
    Ki: torch.Tensor
    KiSKi: torch.Tensor
    noise: torch.Tensor


def qu_predictor(kern: Kernel, kp, Z, log_noise, qu) -> QuPredictor:
    """:class:`QuPredictor` through the same whitened Kmm regularization as
    :func:`svi_bound` (one eigh and one jitter ladder)."""
    noise = positive(log_noise)
    Kmm = kern.K(kp, Z)
    wh = whitening_basis(Kmm)
    Wb = wh.W
    Lk = _whitened_kmm(Kmm, wh)
    m, S, _ = qu_moments(qu)
    a = hdot(Wb, cho_solve(Lk, hdot(Wb.T, m)))
    Rk = solve_triangular(Lk, Wb.T)
    Ki = hdot(Rk.T, Rk)
    KiSKi = torch.einsum("ij,djk,kl->dil", Ki, S, Ki)
    return QuPredictor(a, Ki, KiSKi, noise)


def predict_from(kern: Kernel, kp, Z, pred: QuPredictor, mu_star, s_star=None, *,
                 include_noise: bool = False):
    """The moment-matched predictive at q(x*) = N(mu*, diag(s*)) from a
    :class:`QuPredictor`. Returns (mean (T*, D), var (T*, D))."""
    psi0_s, psi1_s = psi01(kern, kp, Z, mu_star, s_star)
    p2t = psi2_per_t(kern, kp, Z, mu_star, s_star)  # (T*, M, M)
    mean = hdot(psi1_s, pred.a)
    quad = torch.einsum("md,tmn,nd->td", pred.a, p2t, pred.a)
    tr_Ki = torch.einsum("mn,tnm->t", pred.Ki, p2t)
    tr_S = torch.einsum("dmn,tnm->td", pred.KiSKi, p2t)
    var = quad - mean * mean + (psi0_s - tr_Ki)[:, None] + tr_S
    if include_noise:
        var = var + pred.noise
    return mean, torch.maximum(var, _VAR_FLOOR)


def svi_predict(kern: Kernel, kp, Z, log_noise, qu, mu_star, s_star=None, *,
                include_noise: bool = False, jitter: Optional[float] = None):
    """Predictive at q(x*): mean = Psi1* Kmm^{-1} m; the variance includes
    q(u)'s covariance and the psi-statistic moment-matching terms.
    ``jitter`` is accepted for the JAX signature and unused, as there."""
    del jitter
    pred = qu_predictor(kern, kp, Z, log_noise, qu)
    return predict_from(kern, kp, Z, pred, mu_star, s_star, include_noise=include_noise)
