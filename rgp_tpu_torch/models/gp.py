"""Exact GP regression (port of ``rgp_tpu/models/gp.py``): the exactness
oracle that the collapsed sparse bound must match when Z = X."""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels import Kernel
from ..linalg import cho_solve, hdot, jitchol, log_det_from_chol, solve_triangular
from ..params import np_positive_inv, positive

__all__ = ["GPConfig", "init_params", "log_marginal", "neg_log_marginal", "predict"]

_LOG2PI = 1.8378770664093453  # log(2*pi)


@dataclasses.dataclass(frozen=True)
class GPConfig:
    kernel: Kernel


def init_params(cfg: GPConfig, noise: float = 1.0, dtype=torch.float32, device=None, **kern_kw):
    """``device=None`` means the card."""
    dev = resolve_device(device)
    return {
        "kern": cfg.kernel.init(dtype=dtype, device=dev, **kern_kw),
        "log_noise": np_positive_inv(noise, dtype, dev),
    }


def _chol(cfg: GPConfig, params, X):
    noise = positive(params["log_noise"])
    K = cfg.kernel.K(params["kern"], X)
    return jitchol(K + noise * torch.eye(X.shape[0], dtype=K.dtype, device=K.device)), noise


def log_marginal(cfg: GPConfig, params, X, Y):
    """log N(Y | 0, K + sigma^2 I), summed over output dims."""
    T, D = Y.shape
    L, _ = _chol(cfg, params, X)
    a = solve_triangular(L, Y)  # L^{-1} Y
    return -0.5 * T * D * _LOG2PI - 0.5 * D * log_det_from_chol(L) - 0.5 * (a * a).sum()


def neg_log_marginal(cfg: GPConfig, params, X, Y):
    return -log_marginal(cfg, params, X, Y)


def predict(cfg: GPConfig, params, X, Y, Xs, *, full_cov: bool = False, include_noise: bool = True):
    """Posterior predictive at Xs. Returns (mean (T*,D), var (T*,) or (T*,T*))."""
    L, noise = _chol(cfg, params, X)
    Ks = cfg.kernel.K(params["kern"], X, Xs)  # (T, T*)
    mean = hdot(Ks.T, cho_solve(L, Y))
    v = solve_triangular(L, Ks)  # (T, T*)
    if full_cov:
        cov = cfg.kernel.K(params["kern"], Xs) - hdot(v.T, v)
        if include_noise:
            cov = cov + noise * torch.eye(Xs.shape[0], dtype=cov.dtype, device=cov.device)
        return mean, cov
    var = cfg.kernel.Kdiag(params["kern"], Xs) - (v * v).sum(0)
    if include_noise:
        var = var + noise
    return mean, var
