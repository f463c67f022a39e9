"""SVGP: a sparse GP with an explicit q(u) for minibatch training (port of
``rgp_tpu/models/svgp.py``; config 4).

Hyperparameters, Z and q(u) in one tree; the minibatch ELBO of
:mod:`rgp_tpu_torch.inference.svi`; Adam on the hyperparameters with
natural-gradient steps on q(u) (:func:`rgp_tpu_torch.train.fit_minibatch`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..inference import svi
from ..kernels import Kernel
from ..ops.psi_stats import psi_statistics
from ..params import np_positive_inv
from .sparse_gp import host, kmeans_init

__all__ = ["SVGPConfig", "init_params", "elbo", "predict", "freerun_narx"]


@dataclasses.dataclass(frozen=True)
class SVGPConfig:
    kernel: Kernel
    num_inducing: int
    output_dim: int = 1


def init_params(cfg: SVGPConfig, X, noise: float = 0.1, seed: int = 0, dtype=torch.float32,
                device=None, **kern_kw):
    """Z by k-means over ``X`` on the host; ``device=None`` means the card."""
    dev = resolve_device(device)
    Z = kmeans_init(host(X), cfg.num_inducing, seed=seed)
    return {
        "kern": cfg.kernel.init(dtype=dtype, device=dev, **kern_kw),
        "Z": torch.as_tensor(Z, dtype=dtype, device=dev),
        "log_noise": np_positive_inv(noise, dtype, dev),
        "qu": svi.init_qu(cfg.num_inducing, cfg.output_dim, dtype=dtype, device=dev),
    }


def elbo(cfg: SVGPConfig, params, X, Y, *, X_var=None, T_total: Optional[int] = None, block=None):
    """Minibatch ELBO; (X, Y) may be a subset of the data (pass ``T_total``).
    With ``X_var`` the inputs are uncertain, and on a float32 CUDA tensor the
    RBF Psi2 sum runs in K1 (and K2 for its gradient)."""
    stats = psi_statistics(cfg.kernel, params["kern"], params["Z"], X, X_var, block=block)
    return svi.svi_bound(cfg.kernel, params["kern"], params["Z"], params["log_noise"], params["qu"],
                         stats, Y, T_total=T_total)


def predict(cfg: SVGPConfig, params, Xs, *, Xs_var=None, include_noise: bool = True):
    return svi.svi_predict(cfg.kernel, params["kern"], params["Z"], params["log_noise"], params["qu"],
                           Xs, Xs_var, include_noise=include_noise)


def freerun_narx(cfg: SVGPConfig, params, y_win: int, u_win: int, Y_train, U_train, U_test, *,
                 moment_match: bool = True, include_noise_in_state: bool = True):
    """Closed-loop NARX simulation through q(u): as ``gp_narx.freerun``, one
    Python step per test input, but each step predicts through the SVI
    predictive. What does not depend on the query point (Kmm, its whitening
    and factor, Kmm^{-1} m, Kmm^{-1}, Kmm^{-1} S Kmm^{-1}) is formed once
    (:func:`rgp_tpu_torch.inference.svi.qu_predictor`); the JAX package's scan
    recomputes the same values every step. Returns (means, vars), (T*, Dy)."""
    from ..data.windows import current_window

    kern, kp, Z = cfg.kernel, params["kern"], params["Z"]
    pred = svi.qu_predictor(kern, kp, Z, params["log_noise"], params["qu"])
    Ly, Lu = y_win, u_win
    if Lu > 1:
        Uw = current_window(torch.cat([U_train[-(Lu - 1):], U_test], dim=0), Lu)[Lu - 1:]
    elif Lu == 1:
        Uw = current_window(U_test, 1)
    else:
        Uw = U_test.new_zeros((U_test.shape[0], 0))
    u_var = Uw.new_zeros((1, Uw.shape[1]))

    y_mu = torch.flip(Y_train, [0])[:Ly]  # (Ly, Dy), most recent first
    y_var = torch.zeros_like(y_mu)
    means, vars_ = [], []
    for i in range(Uw.shape[0]):
        x_mu = torch.cat([y_mu.reshape(1, -1), Uw[i].reshape(1, -1)], dim=-1)
        x_var = torch.cat([y_var.reshape(1, -1), u_var], dim=-1)
        m, v = svi.predict_from(kern, kp, Z, pred, x_mu, x_var if moment_match else None,
                                include_noise=include_noise_in_state)
        m, v = m[0], v[0]
        y_mu = torch.cat([m[None, :], y_mu[:-1]], dim=0)
        y_var = torch.cat([v[None, :], y_var[:-1]], dim=0)
        means.append(m)
        vars_.append(v)
    return torch.stack(means), torch.stack(vars_)
