"""Sequential Monte Carlo over latent state trajectories (port of
``rgp_tpu/sample/smc.py``, single device): a bootstrap particle filter with
adaptive systematic resampling and an unbiased log-marginal-likelihood
estimate.

The time loop is a Python loop over t with the particles an ``(N,
state_dim)`` tensor; resampling is a ``torch.where`` on a device boolean, so
the loop never waits for the card. Randomness comes from one
``torch.Generator`` on the particles' device: per step one uniform for the
systematic resampling (drawn whether or not it resamples, as the reference
does), then the transition's draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["systematic_resample", "smc_filter", "SMCResult", "ess"]


def ess(log_w):
    """Effective sample size of normalized log-weights."""
    w = torch.softmax(log_w, 0)
    return 1.0 / (w * w).sum()


def systematic_resample(generator: torch.Generator, log_w, n: Optional[int] = None):
    """Systematic (low-variance) resampling: ancestor indices (n,),
    deterministic given the generator's state and ``log_w``."""
    N = log_w.shape[0]
    n = N if n is None else n
    cdf = torch.cumsum(torch.softmax(log_w, 0), 0)
    u0 = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    us = (u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return torch.searchsorted(cdf, us, right=True).clamp(max=N - 1)


class SMCResult(NamedTuple):
    log_marginal: torch.Tensor  # unbiased log p(y_{1:T}) estimate (0-d)
    particles: torch.Tensor  # final particle states (N, ...)
    log_weights: torch.Tensor  # final unnormalized log weights (N,)
    ess_history: torch.Tensor  # (T,)


def smc_filter(
    transition_sample: Callable,  # (generator, particles (N,S), t) -> (N,S)
    emission_logpdf: Callable,  # (particles (N,S), t) -> (N,) log p(y_t | x_t)
    init_sample: Callable,  # (generator, N) -> particles (N,S)
    n_steps: int,
    generator: torch.Generator,
    n_particles: int,
    *,
    ess_threshold: float = 0.5,
) -> SMCResult:
    """Bootstrap particle filter with adaptive systematic resampling on the
    incoming weights; the log-marginal is the running sum of log mean weight
    increments."""
    parts = init_sample(generator, n_particles)
    log_w = parts.new_zeros(n_particles)
    log_Z = parts.new_zeros(())
    ess_hist = []
    for t in range(n_steps):
        cur_ess = ess(log_w)
        resample = cur_ess < ess_threshold * n_particles
        idx = systematic_resample(generator, log_w)
        parts_r = torch.where(resample, parts[idx], parts)
        log_w_r = torch.where(resample, torch.zeros_like(log_w), log_w)
        parts = transition_sample(generator, parts_r, t)
        log_w = log_w_r + emission_logpdf(parts, t)
        log_Z = log_Z + (torch.logsumexp(log_w, 0) - torch.logsumexp(log_w_r, 0))
        ess_hist.append(cur_ess)
    return SMCResult(log_Z, parts, log_w, torch.stack(ess_hist) if ess_hist else parts.new_zeros(0))
