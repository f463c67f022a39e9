"""Sampling entry points over RGP models (port of ``rgp_tpu/sample/api.py``).

``sample_nuts(cfg, params, Y, U, seed, ...)``: NUTS over the kernel
hyperparameters (kernel params + noises) in unconstrained space, holding the
variational state q(X) and the inducing inputs fixed, with potential

    U(theta) = -[ ELBO(theta; q fixed) + log p(theta) ]

and the prior N(0, prior_std^2) placed directly on the unconstrained
parameters (so no Jacobian term: the VI bound stands in for the marginal
likelihood, as in the reference's HMC).

``sample_tempered(cfg, params, Y, U, generator, ...)``: adaptive-tempering
SMC from a Gaussian prior on the hyperparameters to the ELBO surrogate
posterior, with a log-evidence estimate for model comparison; its batched
log-likelihood is :func:`make_rgp_loglik`.

``smc(cfg, params, ...)``: a particle filter over latent trajectories of the
trained model (:func:`rgp_tpu_torch.models.rgp_smc.make_ssm`), its particles
sharded over ranks with ``mesh=``.

``nuts_sharded(potential, z0, seed, mesh, n_chains=...)``: NUTS with the
chains sharded over ranks (``torch.distributed``, one process a rank; see
:mod:`rgp_tpu_torch.parallel`).

The samplers take a BATCHED potential, ``(C, dim) -> (C,)``:
:func:`make_rgp_potential` builds it as ``torch.func.vmap`` of the
single-chain forward, so one ``torch.autograd.grad`` of the sum gives every
chain's gradient. Under the vmap the plain Psi2 path runs without per-chunk
recomputation (``psi_remat=False``) and K1/K2 run once a layer for all
chains, one batched launch each (the vmap rule of
:class:`rgp_tpu_torch.ops.cuda.psi2.RBFPsi2Sum`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models import rgp, rgp_smc
from ..parallel._collectives import all_gather
from ..params import leaves_with_paths, ravel, with_leaves
from .hmc import hmc_sample
from .nuts import NUTSResult, nuts_sample
from .smc import SMCResult, smc_filter, smc_filter_sharded
from .tempered import smc_tempered

__all__ = [
    "split_hypers",
    "merge_hypers",
    "make_rgp_potential",
    "hessian_diagonal",
    "sample_nuts",
    "sample_hmc",
    "make_rgp_loglik",
    "sample_tempered",
    "nuts_sharded",
    "smc",
]

# chain count from which sample_nuts selects the many-chain potential (plain
# chunked Psi2 with a small block and a frozen whitening), as the reference
_MANY_CHAINS = 64


def split_hypers(params):
    """The hyperparameter subtree (kernel params + noises)."""
    return {
        "layers": [{"kern": lp["kern"], "log_noise": lp["log_noise"]} for lp in params["layers"]],
        "out": {"kern": params["out"]["kern"], "log_noise": params["out"]["log_noise"]},
    }


def merge_hypers(params, hyper):
    """A full parameter tree with the hyper subtree replaced."""
    layers = [{**lp, "kern": h["kern"], "log_noise": h["log_noise"]}
              for lp, h in zip(params["layers"], hyper["layers"])]
    out = {**params["out"], "kern": hyper["out"]["kern"], "log_noise": hyper["out"]["log_noise"]}
    return {**params, "layers": layers, "out": out}


def _hyper_elbo(cfg, params, Y, U, *, block, psi_prefer: str, fixed_whitening: bool = False,
                chol_jitter: Optional[float] = None, fresh_ladder: bool = True):
    """-> (hyper_elbo(v, remat), flat0, unravel): ``rgp.elbo`` at ``params``
    with the hyperparameters replaced by the flat vector ``v`` (dim,). Pass
    ``remat=False`` under ``torch.func.vmap`` (``checkpoint`` cannot run on
    batched tensors). The whitening options are :func:`make_rgp_potential`'s."""
    params = with_leaves(params, [x.detach() for _, x in leaves_with_paths(params)])
    flat0, unravel = ravel(split_hypers(params))
    wh = None
    if fixed_whitening:
        with torch.no_grad():
            wh = rgp.compute_whitenings(cfg, params, Y, U, block=block)

    def hyper_elbo(v, remat):
        p = merge_hypers(params, unravel(v))
        wh_eval = wh
        if wh_eval is None and not fresh_ladder:
            wh_eval = rgp.compute_whitenings(cfg, p, Y, U, block=block, ladder=False)
        return rgp.elbo(cfg, p, Y, U, block=block, psi_prefer=psi_prefer, whitening=wh_eval,
                        chol_jitter=chol_jitter, psi_remat=remat)

    return hyper_elbo, flat0, unravel


def make_rgp_potential(cfg, params, Y, U, *, prior_std: float = 3.0, block=None, psi_prefer: str = "auto",
                       fixed_whitening: bool = False, chol_jitter: Optional[float] = 1e-3,
                       fresh_ladder: bool = True):
    """-> (potential, flat0, unravel, batched_potential).

    ``potential(v)``: the single-chain potential of a flat unconstrained
    vector (dim,); ``batched_potential(V)``: (C, dim) -> (C,), its vmap.

    ``chol_jitter`` (1e-3): base jitter of the whitened Cholesky ladders, large
    enough that the first rung succeeds across the sampled region, so the
    ladder's rung flips (cliffs of hundreds of nats at infinitesimal moves,
    the divergence storm the JAX package measured) never trigger. ``None``
    takes the training default.

    ``fixed_whitening``: close over the spectral whitening bases computed once
    at the anchor ``params`` instead of an ``eigh`` per layer per evaluation.
    The bound is W-invariant for any full-rank basis, so the surface is
    unchanged wherever the frozen spectral floor stays inactive; the anchor
    must be a converged optimum for that to hold where the posterior mass is.

    ``fresh_ladder`` (with ``fixed_whitening=False``): keep the spectral-floor
    escalation ladder in the per-evaluation whitening. False recomputes a
    deterministic-floor basis each evaluation (no float32 trial Cholesky,
    whose pass/fail flips put ~1-nat cliffs into the potential).

    ``psi_prefer``: ``"auto"`` (float32 CUDA through K1/K2) or ``"scan"``
    (the plain chunked path, honouring ``block``)."""
    hyper_elbo, flat0, unravel = _hyper_elbo(cfg, params, Y, U, block=block, psi_prefer=psi_prefer,
                                             fixed_whitening=fixed_whitening, chol_jitter=chol_jitter,
                                             fresh_ladder=fresh_ladder)

    def forward(v, remat):
        return -(hyper_elbo(v, remat) - 0.5 * ((v / prior_std) ** 2).sum())

    def potential(v):
        return forward(v, True)

    batched = torch.func.vmap(lambda v: forward(v, False))
    return potential, flat0, unravel, batched


def hessian_diagonal(potential, v):
    """diag of the Hessian of a single-chain potential at ``v``
    (``torch.autograd.functional.hessian``). Build ``potential`` with
    ``psi_prefer="scan"``: K1/K2 are differentiable once."""
    return torch.diagonal(torch.autograd.functional.hessian(potential, v.detach()))


def _jit_scale(mass_inv, base: float = 0.1, cap: float = 0.5):
    """Per-dim init-jitter std: base * sqrt(mass_inv), capped at ``cap``.

    The Hessian-diagonal mass clips |H| at 1e-4, so near-flat directions get
    mass_inv up to 1e4, and an uncapped 0.1 sqrt(mass_inv) jitter flings
    chains ~10 units from the anchor, where the float32 potential is not
    finite, acceptance pins at 0 and the shared dual averaging death-spirals
    the step size (the JAX package measured eps = 0.0 and R-hat 6858)."""
    return torch.clamp(base * torch.sqrt(mass_inv), max=cap)


def sample_nuts(cfg, params, Y, U, seed: int, *, n_samples: int = 200, n_warmup: int = 200,
                n_chains: int = 4, max_depth: int = 6, prior_std: float = 3.0, jitter_init: float = 0.1,
                hessian_precondition: bool = False, psi_prefer: Optional[str] = None,
                block: Optional[int] = None, fixed_whitening: Optional[bool] = None, **nuts_kw) -> NUTSResult:
    """NUTS over RGP hyperparameters, every chain in one batch.

    ``hessian_precondition``: the diagonal inverse mass (and the initial
    jitter's scale) from the potential's Hessian diagonal at ``params``, the
    stiffness fix for GP hyperparameter posteriors; the Hessian is taken of
    the same potential built with ``psi_prefer="scan"`` (dim double
    backwards, once).

    ``psi_prefer``/``block``/``fixed_whitening`` configure the potential (see
    :func:`make_rgp_potential`); by default, from ``_MANY_CHAINS`` chains on,
    the plain chunked Psi2 with ``block=32`` and a frozen whitening, else
    ``"auto"`` and a fresh whitening."""
    many = n_chains >= _MANY_CHAINS
    if psi_prefer is None:
        psi_prefer = "scan" if many else "auto"
    if block is None and many:
        block = 32
    if fixed_whitening is None:
        fixed_whitening = many
    kw = dict(prior_std=prior_std, block=block, fixed_whitening=fixed_whitening)
    _, flat0, _, batched = make_rgp_potential(cfg, params, Y, U, psi_prefer=psi_prefer, **kw)
    std = torch.full_like(flat0, jitter_init)
    if hessian_precondition:
        single_scan = make_rgp_potential(cfg, params, Y, U, psi_prefer="scan", **kw)[0]
        mass_inv0 = 1.0 / torch.clamp(torch.abs(hessian_diagonal(single_scan, flat0)), 1e-4, 1e14)
        nuts_kw.setdefault("mass_inv0", mass_inv0)
        std = _jit_scale(mass_inv0, base=jitter_init)
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn((n_chains, flat0.shape[0]), generator=gen, dtype=flat0.dtype).to(flat0.device)
    z0 = flat0[None, :] + std[None, :] * noise
    # the chains' draws are keyed by (seed + 1, step, chain), apart from the init's
    return nuts_sample(batched, z0, seed + 1, n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
                       max_depth=max_depth, **nuts_kw)


def sample_hmc(cfg, params, Y, U, seed: int, *, prior_std: float = 3.0, psi_prefer: str = "auto", block=None,
               fixed_whitening: bool = False, **hmc_kw):
    """Vanilla HMC over RGP hyperparameters (the reference's sampler);
    ``psi_prefer``/``block``/``fixed_whitening`` go to
    :func:`make_rgp_potential`."""
    _, flat0, _, batched = make_rgp_potential(cfg, params, Y, U, prior_std=prior_std, psi_prefer=psi_prefer,
                                              block=block, fixed_whitening=fixed_whitening)
    return hmc_sample(batched, flat0, seed, **hmc_kw)


def make_rgp_loglik(cfg, params, Y, U, *, psi_prefer: str = "auto", block: Optional[int] = None):
    """-> (batched log-likelihood (N, dim) -> (N,), flat0, unravel): tempered
    SMC's likelihood, ``rgp.elbo`` of each hyperparameter vector with the
    default jitter and a fresh laddered whitening (no prior term), as
    ``torch.func.vmap`` of one vector's bound run under ``torch.no_grad()``.
    On float32 CUDA with ``psi_prefer="auto"`` each layer's Psi2 sum is one
    batched K1 launch for all vectors (the vmap rule of ``RBFPsi2Sum``);
    ``"scan"`` takes the
    plain chunked path at ``block``."""
    hyper_elbo, flat0, unravel = _hyper_elbo(cfg, params, Y, U, block=block, psi_prefer=psi_prefer)
    batched = torch.func.vmap(lambda v: hyper_elbo(v, False))

    def loglik(V):
        with torch.no_grad():
            return batched(V)

    return loglik, flat0, unravel


def sample_tempered(cfg, params, Y, U, generator: torch.Generator, *, n_particles: int = 512,
                    prior_std: float = 3.0, center_on_fit: bool = True, **tsmc_kw):
    """Adaptive-tempering SMC from the hyperparameter prior to the (ELBO
    surrogate) posterior: posterior particles AND a log-evidence estimate
    log Z = log E_prior[exp(ELBO)] for model comparison. Returns
    (:class:`~rgp_tpu_torch.sample.tempered.TemperedSMCResult`, unravel).

    The prior is N(mu0, prior_std^2) on the unconstrained hyperparameters,
    ``mu0`` the fitted ones when ``center_on_fit`` (recommended: a prior
    centred on zero wastes most particles where the ELBO is astronomically
    low), else zero. ``generator`` lives on the data's device; ``tsmc_kw`` go
    to :func:`rgp_tpu_torch.sample.tempered.smc_tempered`."""
    log_lik, flat0, unravel = make_rgp_loglik(cfg, params, Y, U)
    mu0 = flat0 if center_on_fit else torch.zeros_like(flat0)
    dim = flat0.shape[0]
    log_norm = 0.5 * dim * math.log(2.0 * math.pi * prior_std**2)

    def log_prior(V):
        return -0.5 * (((V - mu0) / prior_std) ** 2).sum(-1) - log_norm

    def init_sample(gen, N):
        return mu0[None, :] + prior_std * torch.randn((N, dim), generator=gen, dtype=flat0.dtype,
                                                      device=flat0.device)

    return smc_tempered(log_prior, log_lik, init_sample, generator, n_particles, **tsmc_kw), unravel


def nuts_sharded(potential_fn, z0, seed: int, mesh, *, n_chains: int, axis: str = "chain",
                 **nuts_kw) -> NUTSResult:
    """Chain-sharded NUTS: the ``n_chains`` chains split over ``axis`` of
    ``mesh``, every rank calling with the same arguments. Rank r runs chains
    ``[r k, (r + 1) k)``, k = n_chains / n, through ``nuts_sample(...,
    chain_offset=r k, group=...)``: the step size and mass adapt on every
    chain's statistics, the same bits on every rank, and each chain draws what
    it draws in one process, so the result equals ``nuts_sample`` with the
    same seed and chain count (the JAX package splits one key per device
    instead). Returns the NUTSResult over all chains on every rank."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    if n_chains % n:
        raise ValueError(f"{n_chains} chains do not divide over the {n} ranks of '{axis}'")
    per = n_chains // n
    z0 = torch.atleast_2d(torch.as_tensor(z0))
    if z0.shape[0] != n_chains:
        z0 = z0.expand(n_chains, z0.shape[-1])
    lo = mesh.index(axis) * per
    res = nuts_sample(potential_fn, z0[lo:lo + per], seed, n_chains=per, chain_offset=lo, group=group,
                      **nuts_kw)
    return res._replace(**{k: all_gather(getattr(res, k), group)
                           for k in ("samples", "potential", "accept_prob", "diverging")})


def smc(cfg, params, Y_train, U_train, U_test, Y_test, generator: torch.Generator, *, n_particles: int = 1024,
        ess_threshold: float = 0.5, mesh=None, axis: str = "particle") -> SMCResult:
    """Particle filter over latent trajectories of the trained model, its
    draws from ``generator`` (on the data's device). With a ``mesh``, the
    particles shard over ``axis`` (:func:`~rgp_tpu_torch.sample.smc.
    smc_filter_sharded`): every rank calls with the same arguments and a
    generator in the same state, and gets the one-process result."""
    ssm = rgp_smc.make_ssm(cfg, params, Y_train, U_train, U_test, Y_test)
    if mesh is None:
        return smc_filter(ssm.transition_sample, ssm.emission_logpdf, ssm.init_sample, ssm.n_steps, generator,
                          n_particles, ess_threshold=ess_threshold)
    return smc_filter_sharded(ssm.transition_from_normals, ssm.emission_logpdf, ssm.init_sample, ssm.n_steps,
                              generator, n_particles, mesh, noise_dim=ssm.noise_dim, axis=axis,
                              ess_threshold=ess_threshold)
