"""Sequential Monte Carlo over latent state trajectories (port of
``rgp_tpu/sample/smc.py``): a bootstrap particle filter with adaptive
systematic resampling and an unbiased log-marginal-likelihood estimate, in
one process (:func:`smc_filter`) or with the particles sharded over ranks
(:func:`smc_filter_sharded`).

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

from ..parallel._collectives import all_gather

__all__ = ["systematic_resample", "resample_at", "smc_filter", "smc_filter_sharded", "SMCResult", "ess"]


def ess(log_w):
    """Effective sample size of normalized log-weights."""
    w = torch.softmax(log_w, 0)
    return 1.0 / (w * w).sum()


def systematic_resample(generator: torch.Generator, log_w, n: Optional[int] = None):
    """Systematic (low-variance) resampling: ancestor indices (n,),
    deterministic given the generator's state and ``log_w``."""
    u0 = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    return resample_at(log_w, u0, n)


def resample_at(log_w, u0, n: Optional[int] = None):
    """:func:`systematic_resample` at a given uniform ``u0`` (0-d)."""
    N = log_w.shape[0]
    n = N if n is None else n
    cdf = torch.cumsum(torch.softmax(log_w, 0), 0)
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


def smc_filter_sharded(
    transition_from_normals: Callable,  # (normals (n, noise_dim), particles (n, S), t) -> (n, S)
    emission_logpdf: Callable,  # (particles (n, S), t) -> (n,)
    init_sample: Callable,  # (generator, N) -> particles (N, S)
    n_steps: int,
    generator: torch.Generator,
    n_particles: int,
    mesh,
    *,
    noise_dim: int,
    axis: str = "particle",
    ess_threshold: float = 0.5,
) -> SMCResult:
    """Particle-sharded SMC: :func:`smc_filter`'s math and randomness with the
    particles sharded over ``axis`` of ``mesh``; every rank calls it with the
    same arguments and a generator in the same state.

    The seam for the randomness: the transition is given as
    ``transition_from_normals`` with the ``noise_dim`` standard normals it
    consumes per particle, and each step draws them for ALL ``n_particles``
    (``torch.randn((n_particles, noise_dim), generator, ...)``, the draw a
    :func:`smc_filter` transition of the form ``transition_from_normals(randn
    (...), particles, t)`` makes) and hands each rank its rows. The initial
    particles are drawn whole and sliced, and the resampling uniform is drawn
    on every rank, so every rank consumes the generator as one process does.
    Weights, ESS and logsumexp come from the gathered weights; resampling
    runs replicated on them and takes its ancestors from the gathered
    particles. Returns the whole result on every rank."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    if n_particles % n:
        raise ValueError(f"{n_particles} particles do not divide over the {n} ranks of '{axis}'")
    shard = n_particles // n
    lo = mesh.index(axis) * shard
    parts = init_sample(generator, n_particles)[lo:lo + shard]
    log_w = parts.new_zeros(shard)
    log_Z = parts.new_zeros(())
    ess_hist = []
    for t in range(n_steps):
        log_w_full = all_gather(log_w, group)
        cur_ess = ess(log_w_full)
        resample = cur_ess < ess_threshold * n_particles
        idx = systematic_resample(generator, log_w_full)[lo:lo + shard]
        parts_r = torch.where(resample, all_gather(parts, group)[idx], parts)
        log_w_r = torch.where(resample, torch.zeros_like(log_w), log_w)
        normals = torch.randn((n_particles, noise_dim), generator=generator, dtype=parts.dtype,
                              device=parts.device)[lo:lo + shard]
        parts = transition_from_normals(normals, parts_r, t)
        log_w = log_w_r + emission_logpdf(parts, t)
        # the gathered log_w_r, formed from the gathered log_w
        lse_prev = torch.logsumexp(torch.where(resample, torch.zeros_like(log_w_full), log_w_full), 0)
        log_Z = log_Z + (torch.logsumexp(all_gather(log_w, group), 0) - lse_prev)
        ess_hist.append(cur_ess)
    return SMCResult(log_Z, all_gather(parts, group), all_gather(log_w, group),
                     torch.stack(ess_hist) if ess_hist else parts.new_zeros(0))
