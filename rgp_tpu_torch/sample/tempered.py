"""Adaptive-tempering SMC over a static target (port of
``rgp_tpu/sample/tempered.py``): the log-evidence estimate used for model
comparison.

Likelihood annealing: pi_beta(theta) ∝ p(theta) L(theta)^beta with an
adaptive schedule 0 = beta_0 < ... < beta_K = 1 chosen online so that each
reweighting keeps the effective sample size at ``ess_target * N`` (bisection
on beta, Jasra et al. 2011). Each stage: reweight -> systematic resample ->
``n_moves`` random-walk Metropolis steps targeting pi_beta, the proposal
scaled by the per-dimension particle standard deviation. The product of the
weight-mean increments is an unbiased estimate of the marginal likelihood
Z = ∫ p(theta) L(theta) dtheta.

The JAX package runs the stages as a ``lax.while_loop``. Here the stage loop
is a host loop with one host read a stage, of ``beta < 1`` (the stage count
is the host's own); the 40-step bisection for the next beta is a Python loop
of ``torch.where`` on device tensors. ``log_prior`` and ``log_likelihood``
are BATCHED, (N, D) -> (N,), as the samplers' potentials are.

Randomness comes from one ``torch.Generator`` on the particles' device: the
init particles (``init_sample(generator, N)``), then per stage the resample
uniform and, per move, the proposal normals (N, D) and the accept uniforms
(N,), in that order, the reference's order of keys.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .smc import resample_at

__all__ = ["smc_tempered", "TemperedSMCResult"]

_N_BISECT = 40


class TemperedSMCResult(NamedTuple):
    particles: torch.Tensor  # (N, D) final particles ~ pi_1 = posterior
    log_Z: torch.Tensor  # log marginal-likelihood estimate (0-d)
    betas: torch.Tensor  # (max_stages,) schedule, padded with 1.0
    n_stages: int  # number of tempering stages actually used
    accept_rate: torch.Tensor  # mean MH acceptance over stages and moves (0-d)
    beta_final: torch.Tensor  # last temperature reached; < 1 means max_stages
    #   truncated the anneal and log_Z only covers the prefix to beta_final


def _ess_from_logw(log_w):
    log_w = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * log_w, 0))


def _sanitize_logL(logL):
    """A non-finite log likelihood (a failed Cholesky at extreme
    hyperparameters in float32) means zero target density: NaN and +inf
    become -inf, so the particle gets zero weight instead of poisoning every
    logsumexp downstream."""
    return torch.where(torch.isfinite(logL), logL, -math.inf)


def _incr_logw(delta_beta, logL):
    """delta_beta * logL with the 0 * (-inf) -> NaN corner pinned to -inf."""
    return torch.where(torch.isneginf(logL), -math.inf, delta_beta * logL)


def _next_beta(beta, logL, n_particles: int, ess_target: float, n_bisect: int = _N_BISECT):
    """Largest beta' in (beta, 1] whose incremental weights keep ESS >=
    ess_target * N, by bisection (the ESS is monotone in beta')."""
    target = ess_target * n_particles

    def ess_at(b):
        return _ess_from_logw(_incr_logw(b - beta, logL))

    lo, hi = beta, torch.ones_like(beta)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # if even beta' = 1 keeps the ESS, jump straight to 1
    one = torch.ones_like(beta)
    return torch.where(ess_at(one) >= target, one, lo)


def _generator_draws(generator: torch.Generator, n_particles: int, dim: int, n_moves: int, dtype, device):
    """stage -> (resample uniform (0-d), [(normals (N, D), uniforms (N,))]
    per move), drawn from ``generator`` in the reference's order."""

    def draws(stage):
        u0 = torch.rand((), generator=generator, dtype=dtype, device=device)
        moves = []
        for _ in range(n_moves):
            eps = torch.randn((n_particles, dim), generator=generator, dtype=dtype, device=device)
            moves.append((eps, torch.rand((n_particles,), generator=generator, dtype=dtype, device=device)))
        return u0, moves

    return draws


def _smc_tempered(log_prior: Callable, log_likelihood: Callable, parts0, stage_draws: Callable, *,
                  max_stages: int, ess_target: float, step_scale: float) -> TemperedSMCResult:
    """The sampler from given init particles (N, D) and a ``stage_draws(stage)``
    that returns the stage's resample uniform and each move's (normals,
    uniforms), e.g. the JAX package's own draws for a test."""
    n_particles = parts0.shape[0]
    dtype, dev = parts0.dtype, parts0.device
    parts = parts0
    logL = _sanitize_logL(log_likelihood(parts))
    logP = log_prior(parts)
    beta = torch.zeros((), dtype=dtype, device=dev)
    log_Z = torch.zeros((), dtype=dtype, device=dev)
    acc_sum = torch.zeros((), dtype=dtype, device=dev)
    betas = torch.ones(max_stages, dtype=dtype, device=dev)
    log_n = math.log(float(n_particles))
    stage = 0
    while stage < max_stages and bool(beta < 1.0):
        u_res, moves = stage_draws(stage)
        beta_new = _next_beta(beta, logL, n_particles, ess_target)
        log_w = _incr_logw(beta_new - beta, logL)
        # unbiased increment: the log mean of the incremental weights
        log_Z = log_Z + torch.logsumexp(log_w, 0) - log_n
        idx = resample_at(log_w, u_res)
        parts, logL, logP = parts[idx], logL[idx], logP[idx]

        # n_moves random-walk Metropolis steps targeting pi_beta_new
        std = torch.std(parts, 0, correction=0) + 1e-12  # (D,) adaptive proposal scale
        acc = torch.zeros((), dtype=dtype, device=dev)
        for eps, u in moves:
            prop = parts + step_scale * std * eps
            logL_p = _sanitize_logL(log_likelihood(prop))
            logP_p = log_prior(prop)
            log_alpha = (logP_p + _incr_logw(beta_new, logL_p)) - (logP + _incr_logw(beta_new, logL))
            # a current particle at -inf always escapes to a finite proposal
            log_alpha = torch.where(torch.isneginf(logL) & torch.isfinite(logL_p), math.inf, log_alpha)
            accept = torch.log(u) < log_alpha
            parts = torch.where(accept[:, None], prop, parts)
            logL = torch.where(accept, logL_p, logL)
            logP = torch.where(accept, logP_p, logP)
            acc = acc + accept.to(dtype).mean()
        acc_sum = acc_sum + acc / len(moves)
        betas[stage] = beta_new
        beta = beta_new
        stage += 1
    return TemperedSMCResult(parts, log_Z, betas, stage, acc_sum / max(stage, 1), beta)


def smc_tempered(
    log_prior: Callable,  # (N, D) -> (N,)
    log_likelihood: Callable,  # (N, D) -> (N,), the FULL-data log likelihood
    init_sample: Callable,  # (generator, N) -> (N, D) draws from the prior
    generator: torch.Generator,
    n_particles: int,
    *,
    max_stages: int = 50,
    ess_target: float = 0.5,
    n_moves: int = 3,
    step_scale: float = 0.5,
) -> TemperedSMCResult:
    """Adaptive-tempering SMC from the prior to the posterior.

    Returns the posterior particles, an unbiased ``log_Z`` (log marginal
    likelihood), the adaptive beta schedule and the MH acceptance rate;
    ``generator`` lives on the particles' device."""
    parts0 = init_sample(generator, n_particles)
    draws = _generator_draws(generator, n_particles, parts0.shape[-1], n_moves, parts0.dtype, parts0.device)
    return _smc_tempered(log_prior, log_likelihood, parts0, draws, max_stages=max_stages, ess_target=ess_target,
                         step_scale=step_scale)
