"""GP-NARX: the sparse-VI autoregressive GP baseline, config 3 (port of
``rgp_tpu/models/gp_narx.py``).

y_t is regressed on [y_{t-1..t-Ly}, u_t..u_{t-Lu+1}] with a sparse GP on
certain inputs. :func:`freerun` rolls the model closed-loop, one Python step
per test input; with ``moment_match=True`` the fed-back outputs carry their
predictive variance through the psi-statistics, the uncertain-input path the
RGP's free simulation uses too.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.windows import current_window, narx_design, np_narx_design
from ..inference.collapsed_vi import posterior, predict_uncertain
from ..kernels import Kernel
from ..ops.psi_stats import psi_statistics
from ..params import positive
from . import sparse_gp

__all__ = ["NARXConfig", "init_params", "elbo", "freerun"]


@dataclasses.dataclass(frozen=True)
class NARXConfig:
    kernel: Kernel
    num_inducing: int
    y_win: int
    u_win: int
    # additive lower bound on the noise variance (0 disables): long float32
    # cosine schedules otherwise collapse the noise, and the beta^2 rounding
    # then corrupts the bound
    noise_floor: float = 1e-4

    @property
    def sparse(self) -> sparse_gp.SparseGPConfig:
        return sparse_gp.SparseGPConfig(self.kernel, self.num_inducing)


def init_params(cfg: NARXConfig, Y, U=None, noise: float = 0.1, seed: int = 0,
                dtype=torch.float32, device=None, **kern_kw):
    """k-means init over the NARX design, on the host; ``device=None`` means
    the card."""
    X, _ = np_narx_design(sparse_gp.host(Y), None if U is None else sparse_gp.host(U),
                          cfg.y_win, cfg.u_win)
    return sparse_gp.init_params(cfg.sparse, X, noise=noise, seed=seed, dtype=dtype,
                                 device=device, **kern_kw)


def _fln(cfg: NARXConfig, log_noise):
    if cfg.noise_floor <= 0.0:
        return log_noise
    return torch.log(torch.expm1(positive(log_noise) + cfg.noise_floor))


def elbo(cfg: NARXConfig, params, Y, U=None, *, block=None):
    X, Yt = narx_design(Y, U, cfg.y_win, cfg.u_win)
    params = {**params, "log_noise": _fln(cfg, params["log_noise"])}
    return sparse_gp.elbo(cfg.sparse, params, X, Yt, block=block)


def freerun(cfg: NARXConfig, params, Y_train, U_train, U_test, y_init, *,
            moment_match: bool = True, include_noise_in_state: bool = True):
    """Closed-loop simulation over the test inputs.

    ``y_init``: (y_win, Dy) the last training outputs seeding the feedback
    window. Returns (means (T*, Dy), vars (T*, Dy))."""
    X, Yt = narx_design(Y_train, U_train, cfg.y_win, cfg.u_win)
    ln = _fln(cfg, params["log_noise"])
    kern, kp, Z = cfg.kernel, params["kern"], params["Z"]
    stats = psi_statistics(kern, kp, Z, X, None, block=None)
    post = posterior(kern, kp, Z, ln, stats, Yt, certain=True)
    Ly, Lu = cfg.y_win, cfg.u_win

    # exogenous window rows [u_t, ..., u_{t-Lu+1}] over test steps, seeded
    # from the training tail so the first steps see real lags
    if Lu > 1:
        Uw = current_window(torch.cat([U_train[-(Lu - 1):], U_test], dim=0), Lu)[Lu - 1:]
    elif Lu == 1:
        Uw = current_window(U_test, 1)
    else:
        Uw = U_test.new_zeros((U_test.shape[0], 0))
    u_var = Uw.new_zeros((1, Uw.shape[1]))

    y_mu = torch.flip(y_init, [0])[:Ly]  # (Ly, Dy), most recent first
    y_var = torch.zeros_like(y_mu)
    means, vars_ = [], []
    for i in range(Uw.shape[0]):
        x_mu = torch.cat([y_mu.reshape(1, -1), Uw[i].reshape(1, -1)], dim=-1)
        x_var = torch.cat([y_var.reshape(1, -1), u_var], dim=-1)
        m, v = predict_uncertain(kern, kp, Z, ln, post, x_mu, x_var if moment_match else None,
                                 include_noise=include_noise_in_state)
        m, v = m[0], v[0]
        y_mu = torch.cat([m[None, :], y_mu[:-1]], dim=0)
        y_var = torch.cat([v[None, :], y_var[:-1]], dim=0)
        means.append(m)
        vars_.append(v)
    return torch.stack(means), torch.stack(vars_)
