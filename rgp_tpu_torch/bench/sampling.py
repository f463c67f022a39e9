"""Sampling-throughput benchmark, config 5 (the twin of
``rgp_tpu/bench/sampling.py``):

  * NUTS samples/s at ``--chains`` chains over the flagship hyperparameter
    potential (1-layer RGP on actuator, M=100: the potential ``sample_nuts``
    uses), warmup and draw phases timed apart (the draw rate is the headline);
  * SMC particle-filter steps/s at ``--particles`` particles over latent
    trajectories of the trained flagship (``rgp_smc.make_ssm``).

    python -m rgp_tpu_torch.bench.sampling --what nuts --params-npz artifacts/pcheck_params_r5.npz \\
        --chains 128 --warmup 24 --samples 8
    python -m rgp_tpu_torch.bench.sampling --what smc --particles 1024

It keeps the JAX protocol and defaults: the potential on the plain chunked
Psi2 path (``psi_prefer="scan"``, block 32) with the whitening frozen at the
anchor, the Hessian-diagonal mass with the capped init jitter, chain groups
of ``--group-size`` each warmed independently (its own jitter, adaptation and
draws through ``chain_offset``), warmup in segments of ``--seg`` steps, one
draw per call, and one untimed warmup segment and draw before the clocks
start. The JAX package forced ``"scan"`` for a TPU compiler limit; on the
card both routes run (``make_rgp_potential(psi_prefer=...)``).

The last line of standard output is one JSON object with the JAX
benchmark's keys; ``backend`` is the card's name, ``card`` its name and
power limit from ``nvidia-smi``. It runs on the card only. Timing ends in a
host read of a result, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import train
from ..data import datasets
from ..device import resolve_device
from ..models import rgp
from ..params import leaves_with_paths, with_leaves

__all__ = ["_flagship", "bench_nuts", "bench_smc", "main"]


def _flagship(fit_iters: int, dtype, params_npz: str | None = None, noise_floor: float | None = None,
              device=None):
    """Config 1's flagship: a 1-layer RGP on actuator (M=100), fitted for
    ``fit_iters`` Adam steps (cosine decay from 1e-2 to 1e-4) or loaded from
    ``params_npz``, a flat npz of leaves ``p0..p11`` in the JAX package's
    flatten order (the port's ``leaves_with_paths`` order; e.g.
    ``artifacts/pcheck_params_r5.npz``). Returns (cfg, params, Y, U, U_test,
    Y_test); ``device=None`` means the card."""
    dev = resolve_device(device)
    t = datasets.standardized_tensors(datasets.load("actuator"), dtype=dtype, device=dev)
    kw = {} if noise_floor is None else {"noise_floor": noise_floor}
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100, **kw)
    params = rgp.init_params(cfg, t.Y, t.U, dtype=dtype, device=dev)
    if params_npz is not None:
        with np.load(params_npz) as z:
            flat = [z[f"p{i}"] for i in range(len(z.files))]
        ours = leaves_with_paths(params)
        if [tuple(x.shape) for _, x in ours] != [x.shape for x in flat]:
            raise ValueError(f"{params_npz}: leaf shapes {[x.shape for x in flat]} do not match the flagship's")
        params = with_leaves(params, [torch.as_tensor(x, dtype=dtype, device=dev) for x in flat])
    elif fit_iters > 0:
        params = train.fit_adam(lambda p: -rgp.elbo(cfg, p, t.Y, t.U, block=None), params, iters=fit_iters,
                                learning_rate=train.cosine_decay_schedule(1e-2, fit_iters, 0.01)).params
    return cfg, params, t.Y, t.U, t.U_test, t.Y_test


def _card(dev):
    if dev.type != "cuda":
        return dev.type, None
    from .config1 import card

    return torch.cuda.get_device_name(dev), card()


def bench_nuts(chains: int, warmup: int, samples: int, max_depth: int, fit_iters: int, seed: int = 0,
               group_size: int = 128, block: int = 32, target_accept: float = 0.6, seg: int = 3,
               shared_warmup: bool = False, params_npz: str | None = None, warmup_depth: int | None = None,
               init_eps: float = 0.1, device=None, return_draws: bool = False, adapt_mass: bool = True,
               mass_from: str | None = None, init_from: str | None = None, model=None):
    """The NUTS record. ``chains`` must be a multiple of ``group_size`` and
    ``warmup`` of ``seg``. Every group warms up independently unless
    ``shared_warmup`` (one warmed group copied to all, recorded in
    ``independent_warmup_chains``). ``init_eps`` is dual averaging's starting
    step size; ``warmup_depth`` caps the tree depth in warmup only;
    ``adapt_mass`` False keeps the initial mass through warmup.
    ``return_draws``: also return the draws (chains, samples, dim) and their
    divergence flags.

    The initial mass is the Hessian diagonal's, or with ``mass_from`` the
    empirical variance of the draws in that npz; each group starts at the
    anchor plus the capped jitter, or with ``init_from`` at draws picked from
    that npz (``posterior_check``'s options). ``model``: (cfg, params, Y, U,
    ...) in place of ``_flagship(fit_iters, float32, params_npz)``."""
    from ..sample.api import make_rgp_potential
    from ..sample.diagnostics import ess, split_rhat
    from ..sample.hmc import step_draws
    from ..sample.nuts import nuts_draw, nuts_init, nuts_warmup
    from .posterior_check import _draws_of, _initial_mass, _jit_scale

    if chains % group_size or warmup % seg:
        raise ValueError("chains must be a multiple of group_size and warmup a multiple of seg")
    if model is None:
        model = _flagship(fit_iters, torch.float32, params_npz, device=device)
    cfg, params, Y, U = model[:4]
    dev = Y.device
    potential, flat0, _, batched = make_rgp_potential(cfg, params, Y, U, block=block, psi_prefer="scan",
                                                      fixed_whitening=True)
    k_init, k_warm, k_draw = seed, seed + 1, seed + 2
    wc = min(group_size, chains)
    n_groups = chains // wc

    # Hessian-diagonal mass: without it dual averaging collapses eps on this
    # stiff posterior and every tree saturates max_depth
    mass_inv0 = _initial_mass(potential, flat0, mass_from)
    pool = None if init_from is None else _draws_of(init_from, flat0.shape[0])

    def group_z0(g):
        if pool is not None:
            idx = np.random.default_rng([k_init, g]).choice(pool.shape[0], wc, replace=pool.shape[0] < wc)
            return torch.as_tensor(pool[idx], dtype=flat0.dtype, device=dev)
        normals, _ = step_draws(k_init, g, wc, 0, flat0.shape[0], 0, flat0.dtype, dev)
        return flat0[None, :] + _jit_scale(mass_inv0)[None, :] * normals

    w_depth = max_depth if warmup_depth is None else warmup_depth

    def init(g):
        return nuts_init(group_z0(g), n_chains=wc, mass_inv=mass_inv0, step_size=init_eps)

    def warm(c, g):
        return nuts_warmup(batched, c, k_warm, seg, n_warmup=warmup, max_depth=w_depth,
                           target_accept=target_accept, chain_offset=g * wc, adapt_mass=adapt_mass)

    def draw1(c, g):
        return nuts_draw(batched, c, k_draw, 1, max_depth=max_depth, chain_offset=g * wc)

    # one untimed warmup segment and draw (allocator, cuBLAS/cuSOLVER set-up)
    float(draw1(warm(init(0), 0), 0)[0].zs[0, 0])

    n_warm_groups = 1 if shared_warmup else n_groups
    group_carries = []
    t0 = time.perf_counter()
    for g in range(n_warm_groups):
        c = init(g)
        for _ in range(0, warmup, seg):
            c = warm(c, g)
        group_carries.append(c)
    for c in group_carries:
        float(c.zs[0, 0])  # host-read barrier
    t_warm = time.perf_counter() - t0
    if shared_warmup:
        group_carries = [group_carries[0] for _ in range(n_groups)]

    results = []
    t0 = time.perf_counter()
    for g in range(n_groups):
        c = group_carries[g]
        for _ in range(samples):
            c, r = draw1(c, g)
            results.append(r)
        group_carries[g] = c
    for c in group_carries:
        float(c.zs[0, 0])
    t_draw = time.perf_counter() - t0

    accs = torch.cat([r.accept_prob.reshape(-1) for r in results])
    divs = torch.cat([r.diverging.reshape(-1) for r in results])
    eps_per_group = [float(torch.exp(c.da.log_eps_avg)) for c in group_carries]
    backend, card = _card(dev)
    details = {
        "backend": backend,
        "card": card,
        "chains": chains,
        "chain_group_size": wc,
        "independent_warmup_chains": wc * n_warm_groups,
        "n_samples": samples,
        "n_warmup": warmup,
        "warmup_seg": seg,
        "max_depth": max_depth,
        "warmup_depth": w_depth,
        "init_eps": init_eps,
        "target_accept": target_accept,
        "draw_seconds": t_draw,
        "warmup_seconds": t_warm,
        "warmup_samples_per_sec": n_warm_groups * wc * warmup / t_warm,
        "mean_accept": float(accs.mean()),
        "divergence_rate": float(divs.double().mean()),
        "step_size_per_group": eps_per_group,
        "potential_dim": int(flat0.shape[0]),
    }
    # draws per group in dispatch order: (chains, samples, ...)
    by_group = [results[g * samples:(g + 1) * samples] for g in range(n_groups)]
    draws = np.concatenate([np.concatenate([r.samples.cpu().numpy() for r in rs], 1) for rs in by_group], 0)
    diverging = np.concatenate([np.concatenate([r.diverging.cpu().numpy() for r in rs], 1) for rs in by_group], 0)
    if samples >= 4:  # cross-chain diagnostics on the potential-energy trace
        U_draws = np.concatenate([np.concatenate([r.potential.cpu().numpy() for r in rs], 1) for rs in by_group], 0)
        details["potential_split_rhat"] = float(split_rhat(U_draws))
        details["potential_ess"] = float(ess(U_draws))
    record = {
        "metric": f"nuts_samples_per_sec[rgp1L_actuator_M100_chains{chains}]",
        "value": n_groups * wc * samples / t_draw,
        "unit": "samples/s",
        "vs_baseline": None,
        "details": details,
    }
    return (record, draws, diverging) if return_draws else record


def bench_smc(particles: int, fit_iters: int, seed: int = 0, device=None, return_result: bool = False):
    """The SMC record: the filter over the test span of the flagship fitted
    for ``fit_iters`` steps, run once untimed, then timed. ``return_result``
    also returns the timed run's ``SMCResult``."""
    from ..sample.api import smc

    cfg, params, Y, U, Ut, Yt = _flagship(fit_iters, torch.float32, device=device)
    dev = Y.device

    def run():
        res = smc(cfg, params, Y, U, Ut, Yt, torch.Generator(dev).manual_seed(seed), n_particles=particles)
        float(res.log_marginal)  # host-read barrier
        return res

    run()
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    n_steps = int(res.ess_history.shape[0])
    backend, card = _card(dev)
    record = {
        "metric": f"smc_filter_steps_per_sec[rgp1L_actuator_N{particles}]",
        "value": n_steps / dt,
        "unit": "steps/s",
        "vs_baseline": None,
        "details": {
            "backend": backend,
            "card": card,
            "particles": particles,
            "n_steps": n_steps,
            "wall_seconds": dt,
            "particle_steps_per_sec": particles * n_steps / dt,
            "log_marginal": float(res.log_marginal),
            "mean_ess_frac": float(res.ess_history.mean()) / particles,
        },
    }
    return (record, res) if return_result else record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", "--sampler", dest="what", choices=("nuts", "smc"), default="nuts")
    ap.add_argument("--chains", type=int, default=256, help="must be a multiple of --group-size")
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--particles", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=96, help="total warmup steps (multiple of --seg)")
    ap.add_argument("--samples", "--draws", dest="samples", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--target-accept", type=float, default=0.6,
                    help="below the float32 evaluation-noise acceptance ceiling of the flagship")
    ap.add_argument("--seg", type=int, default=3, help="warmup steps per call")
    ap.add_argument("--warmup-depth", type=int, default=None,
                    help="NUTS depth cap during warmup only (draws keep --max-depth)")
    ap.add_argument("--init-eps", type=float, default=0.1, help="dual-averaging starting step size")
    ap.add_argument("--shared-warmup", action="store_true", help="one warmed group copied to all")
    ap.add_argument("--params-npz", default=None, help="anchor params, a flat npz of leaves p0..p11")
    ap.add_argument("--fit-iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sampling: no CUDA device; this benchmark runs on the card only")

    if args.what == "nuts":
        out = bench_nuts(args.chains, args.warmup, args.samples, args.max_depth, args.fit_iters, args.seed,
                         group_size=args.group_size, target_accept=args.target_accept, seg=args.seg,
                         shared_warmup=args.shared_warmup, params_npz=args.params_npz,
                         warmup_depth=args.warmup_depth, init_eps=args.init_eps)
    else:
        out = bench_smc(args.particles, args.fit_iters, args.seed)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
