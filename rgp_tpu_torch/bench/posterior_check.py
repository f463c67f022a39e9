"""Config-5 posterior validation at benchmark scale (the twin of
``rgp_tpu/bench/posterior_check.py``).

Validates that the benchmarked float32 sampler (frozen whitening basis, the
plain chunked Psi2, grouped chains, Hessian-preconditioned mass) samples the
same posterior as a float64 NUTS reference on the same potential (same
anchor parameters, prior and data). Five modes share one anchor:

  fit              fit the flagship briefly and save the anchor parameters, a
                   flat npz of leaves ``p0..pN`` in the JAX package's leaf
                   order (either package's ``_flagship(params_npz=...)``
                   reads it)
  card             the benchmarked float32 sampler (the JAX ``tpu`` mode),
                   keeping its draws, saved as an npz
  ref              the float64 reference (the JAX ``cpu-ref`` mode) on the
                   device it is given (the card by default): a fresh basis at
                   the pinned base floor (``fresh_ladder=False``) or, with
                   ``--frozen-basis``, the frozen-anchor bound; resumable
  surrogate-check  the true bound (float64, fresh whitening) against the
                   frozen-basis surrogate (float64 and float32) at the
                   anchor, at draws of the sampler and at the reference
                   chains' last positions
  compare          per-dimension moment deltas in combined MC-error units,
                   std ratios, split-R-hat/ESS of both runs (``compare_draws``)

The npz files have the JAX package's keys (``draws``, ``diverging``,
``wall_seconds``, ...), so the committed ``artifacts/pcheck_*_r5.npz`` feed
either package. Every mode takes its model through one seam, ``_flagship``
(``bench.sampling._flagship``). Without ``--out`` a mode writes under the
temporary directory, as the JAX module writes under ``/tmp``.

    python -m rgp_tpu_torch.bench.posterior_check --mode fit --out pc_params.npz
    python -m rgp_tpu_torch.bench.posterior_check --mode card --params pc_params.npz \\
        --chains 256 --warmup 96 --samples 64 --out pc_card.npz
    python -m rgp_tpu_torch.bench.posterior_check --mode ref --params pc_params.npz \\
        --chains 2 --warmup 200 --samples 200 --out pc_ref.npz
    python -m rgp_tpu_torch.bench.posterior_check --mode compare --tpu pc_card.npz --cpu pc_ref.npz

``--tpu`` and ``--cpu`` keep the JAX flags' names: the benchmarked sampler's
draws and the reference's. Each mode runs on the card unless given
``--device cpu``; one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..params import leaves_with_paths
from ..sample.api import _jit_scale, hessian_diagonal, make_rgp_potential
from ..sample.diagnostics import ess, split_rhat
from ..utils import checkpoint
from .sampling import _flagship

__all__ = ["_jit_scale", "compare_draws", "mode_fit", "mode_card", "mode_ref", "mode_surrogate_check",
           "mode_compare", "main"]


def compare_draws(d_t, div_t, d_c, div_c) -> dict:
    """Per-dimension moment deltas of draws ``d_t`` (chains, draws, dim)
    against reference draws ``d_c`` of the same potential, in combined
    Monte-Carlo-error units |mean_t - mean_c| / sqrt(se_t^2 + se_c^2) (se from
    the per-dim bulk ESS), std ratios, and split-R-hat / ESS of both;
    ``div_*`` are the (chains, draws) divergence flags. Dimensions where the
    reference has not mixed (ESS < 20 or R-hat > 1.2) cannot arbitrate a
    discrepancy and are also reported apart. The statistics of the JAX
    package's ``mode_compare``, with ``draws``/``reference`` for its
    ``tpu``/``cpu_ref``."""

    def _stats(d):
        flat = d.reshape(-1, d.shape[-1])
        e = np.atleast_1d(ess(d))
        se = flat.std(axis=0, ddof=1) / np.sqrt(np.maximum(e, 1.0))
        return flat.mean(axis=0), flat.std(axis=0, ddof=1), e, se

    m_t, s_t, e_t, se_t = _stats(d_t)
    m_c, s_c, e_c, se_c = _stats(d_c)
    z_scores = np.abs(m_t - m_c) / np.sqrt(se_t**2 + se_c**2)
    std_ratio = s_t / np.maximum(s_c, 1e-30)
    r_t = np.atleast_1d(split_rhat(d_t))
    r_c = np.atleast_1d(split_rhat(d_c))
    ok = (e_c >= 20.0) & (r_c <= 1.2)
    well = {
        "n_dims": int(ok.sum()),
        "moment_z_max": float(np.nanmax(z_scores[ok])) if ok.any() else None,
        "moment_z_median": float(np.nanmedian(z_scores[ok])) if ok.any() else None,
        "n_z_above_3": int(np.sum(z_scores[ok] > 3.0)) if ok.any() else None,
        "std_ratio_range": [float(std_ratio[ok].min()), float(std_ratio[ok].max())] if ok.any() else None,
    }
    return {
        "well_mixed_reference_dims": well,
        "dim": int(d_t.shape[-1]),
        "draws": {"chains": int(d_t.shape[0]), "draws": int(d_t.shape[1]),
                  "divergence_rate": float(div_t.mean()), "max_rhat": float(np.nanmax(r_t)),
                  "min_ess": float(np.nanmin(e_t)), "median_ess": float(np.nanmedian(e_t))},
        "reference": {"chains": int(d_c.shape[0]), "draws": int(d_c.shape[1]),
                      "divergence_rate": float(div_c.mean()), "max_rhat": float(np.nanmax(r_c)),
                      "min_ess": float(np.nanmin(e_c))},
        "moment_z_max": float(np.nanmax(z_scores)),
        "moment_z_median": float(np.nanmedian(z_scores)),
        "n_dims_z_above_3": int(np.sum(z_scores > 3.0)),
        "std_ratio_range": [float(std_ratio.min()), float(std_ratio.max())],
    }


def _draws_of(path: str, dim: int):
    """The draws of an npz, (n, dim)."""
    with np.load(path) as z:
        return z["draws"].reshape(-1, dim)


def _initial_mass(potential, flat0, mass_from: str | None = None):
    """The diagonal inverse mass both samplers start from: 1 / |Hessian
    diagonal| of the single-chain ``potential`` at ``flat0``, clipped to
    [1e-4, 1e14], or with ``mass_from`` the empirical variance of that npz's
    draws, floored at 1e-6 (the overdispersed-initialization protocol of the
    JAX module: the Hessian mass underestimates the broad directions)."""
    if mass_from is not None:
        var = _draws_of(mass_from, flat0.shape[0]).var(axis=0, ddof=1)
        return torch.clamp(torch.as_tensor(var, dtype=flat0.dtype, device=flat0.device), min=1e-6)
    return 1.0 / torch.clamp(torch.abs(hessian_diagonal(potential, flat0)), 1e-4, 1e14)


def _save_params(path: str, params) -> None:
    np.savez(path, **{f"p{i}": x.detach().cpu().numpy() for i, (_, x) in enumerate(leaves_with_paths(params))})


def _default(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def mode_fit(out: str, fit_iters: int, device=None) -> dict:
    """Fit the flagship for ``fit_iters`` Adam steps in float32 and save its
    parameters to ``out``."""
    _, params, *_ = _flagship(fit_iters, torch.float32, device=device)
    _save_params(out, params)
    return {"mode": "fit", "out": out, "fit_iters": fit_iters}


def mode_card(params_npz: str, out: str, chains: int, warmup: int, samples: int, max_depth: int,
              target_accept: float, group_size: int, seg: int, seed: int, noise_floor: float | None = None,
              adapt_mass: bool = False, init_from: str | None = None, mass_from: str | None = None,
              device=None) -> dict:
    """The benchmarked configuration (``bench.sampling.bench_nuts``'s), with
    its draws kept, saved to ``out``; groups of ``min(group_size, chains)``
    chains.

    ``adapt_mass`` defaults off: the Hessian diagonal mass is kept through
    warmup (the JAX module measured the pooled-Welford switch multiply the
    largest inverse mass ~10x from barely warmed chains). ``init_from`` /
    ``mass_from``: start the chains at draws of that npz / take the mass
    from their empirical variance (the JAX module found anchor-local inits
    leave the whole ensemble in a shell ~270 nats above the bulk)."""
    from .sampling import bench_nuts

    model = _flagship(0, torch.float32, params_npz, noise_floor=noise_floor, device=device)
    record, draws, div = bench_nuts(chains, warmup, samples, max_depth, 0, seed, group_size=min(group_size, chains),
                                    target_accept=target_accept, seg=seg, return_draws=True,
                                    adapt_mass=adapt_mass, mass_from=mass_from, init_from=init_from,
                                    model=model)
    det = record["details"]
    t_warm, t_draw = det["warmup_seconds"], det["draw_seconds"]
    wall = t_warm + t_draw
    np.savez(out, draws=draws, diverging=div, wall_seconds=wall, max_depth=max_depth,
             target_accept=target_accept, warmup=warmup)
    r_pos = np.atleast_1d(split_rhat(draws))
    e_pos = np.atleast_1d(ess(draws))
    return {
        "mode": "card", "out": out, "chains": chains, "samples": samples,
        "warmup": warmup, "wall_seconds": wall,
        "warmup_seconds": t_warm,
        "draw_seconds": t_draw,
        "samples_per_sec_draw_phase": chains * samples / t_draw,
        "warmup_chain_steps_per_sec": chains * warmup / t_warm,
        "independent_warmup_chains": det["independent_warmup_chains"],
        "mean_accept": det["mean_accept"],
        "divergence_rate": det["divergence_rate"],
        "step_size_per_group": det["step_size_per_group"],
        "max_rhat_positions": float(np.nanmax(r_pos)),
        "min_ess_positions": float(np.nanmin(e_pos)),
        "median_ess_positions": float(np.nanmedian(e_pos)),
        "target_accept": target_accept, "max_depth": max_depth,
        "init": "anchor+jitter" if init_from is None else f"draws:{init_from}",
        "mass": "hessian" if mass_from is None else f"emp_var:{mass_from}",
    }


def mode_ref(params_npz: str, out: str, chains: int, warmup: int, samples: int, max_depth: int,
             target_accept: float, seed: int, noise_floor: float | None = None, mass_from: str | None = None,
             init_from: str | None = None, seg: int = 8, draw_seg: int = 4, frozen_basis: bool = False,
             device=None) -> dict:
    """The float64 reference on ``device`` (None: the card; float64 takes the
    plain Psi2 path there): NUTS at the same depth and target, warmup in
    segments of ``seg`` steps and draws in segments of ``draw_seg``, the
    mass kept through warmup.

    The target: ``frozen_basis`` the matched-policy reference, the
    frozen-anchor whitened bound the card's sampler uses, in float64; else a
    fresh basis at every evaluation at the pinned base floor
    (``fresh_ladder=False``: the ladder's discrete trial makes the fresh
    potential cliffy). The JAX module measured the latter unwall a
    low-noise funnel ~275 nats below the anchor optimum: a different,
    collapse-prone model.

    ``mass_from``: the mass from the empirical variance of those draws;
    ``init_from``: chain 0 at the anchor and the rest at draws of that npz
    picked without replacement (else the capped jitter around the anchor).

    Resumable: after every segment the whole state (the NUTS carry, the
    draws banked, the wall time) is saved through
    :mod:`rgp_tpu_torch.utils.checkpoint` under ``<out>.ckpt/``, and the
    draws so far to ``out``. The draws of a step are keyed by (seed, step,
    chain), so a killed run, started again with the same arguments, resumes
    to the same bits."""
    dev = resolve_device(device)
    cfg, params, Y, U, _, _ = _flagship(0, torch.float64, params_npz, noise_floor=noise_floor, device=dev)
    potential, flat0, _, batched = make_rgp_potential(cfg, params, Y, U, block=64, psi_prefer="scan",
                                                      fixed_whitening=frozen_basis, fresh_ladder=False)
    from ..sample.nuts import nuts_draw, nuts_init, nuts_warmup

    if warmup % seg or samples % draw_seg:
        raise ValueError("warmup must be a multiple of seg and samples of draw_seg")
    mass_inv0 = _initial_mass(potential, flat0, mass_from)
    dim = flat0.shape[0]
    rng = np.random.default_rng(seed + 1000)
    if init_from is not None:
        pool = _draws_of(init_from, dim)
        z0 = torch.as_tensor(pool[rng.choice(pool.shape[0], chains, replace=False)], dtype=flat0.dtype,
                             device=dev)
        z0[0] = flat0  # chain 0 from the anchor
        init_src = "anchor+draws"
    else:
        normals = torch.as_tensor(rng.standard_normal((chains, dim)), dtype=flat0.dtype, device=dev)
        z0 = flat0[None, :] + _jit_scale(mass_inv0)[None, :] * normals
        init_src = "anchor+jitter"
    k_run = seed + 1001

    ckpt = out + ".ckpt"
    state = {
        "carry": nuts_init(z0, n_chains=chains, mass_inv=mass_inv0),
        "draws": torch.zeros((chains, samples, dim), dtype=flat0.dtype, device=dev),
        "diverging": torch.zeros((chains, samples), dtype=torch.bool, device=dev),
        "n_draws": 0,
        "wall_seconds": 0.0,
    }
    last = checkpoint.latest_step(ckpt)
    if last is not None:
        state, _ = checkpoint.load_checkpoint(ckpt, template=state, step=last)
        print(f"resumed from {ckpt}: step {state['carry'].step}, {state['n_draws']} draws banked", flush=True)

    meta = {"max_depth": max_depth, "target_accept": target_accept, "warmup": warmup, "frozen_basis": frozen_basis}
    wall_prev, t0 = state["wall_seconds"], time.perf_counter()

    def flush():
        """Checkpoint the state and write the draws so far; returns the wall
        seconds."""
        nonlocal last
        state["wall_seconds"] = wall_prev + time.perf_counter() - t0
        step = state["carry"].step
        checkpoint.save_checkpoint(ckpt, state, step)
        if last is not None and last != step:
            shutil.rmtree(os.path.join(os.path.abspath(ckpt), f"step_{last:08d}"), ignore_errors=True)
        last = step
        n = state["n_draws"]
        np.savez(out, draws=state["draws"][:, :n].cpu().numpy(), diverging=state["diverging"][:, :n].cpu().numpy(),
                 wall_seconds=state["wall_seconds"], **meta)
        return state["wall_seconds"]

    while state["carry"].step < warmup:
        state["carry"] = nuts_warmup(batched, state["carry"], k_run, seg, n_warmup=warmup, max_depth=max_depth,
                                     target_accept=target_accept, adapt_mass=False)
        wall = flush()
        print(f"warmup {state['carry'].step}/{warmup} ({wall:.0f}s, "
              f"eps {float(torch.exp(state['carry'].da.log_eps)):.4g})", flush=True)
    while state["n_draws"] < samples:
        state["carry"], res = nuts_draw(batched, state["carry"], k_run, draw_seg, max_depth=max_depth)
        n = state["n_draws"]
        state["draws"][:, n:n + draw_seg] = res.samples
        state["diverging"][:, n:n + draw_seg] = res.diverging
        state["n_draws"] = n + draw_seg
        wall = flush()
        print(f"draws {state['n_draws']}/{samples} ({wall:.0f}s)", flush=True)

    draws = state["draws"].cpu().numpy()
    r = np.atleast_1d(split_rhat(draws))
    e = np.atleast_1d(ess(draws))
    return {
        "mode": "ref", "out": out, "chains": chains,
        "samples": int(draws.shape[1]),
        "warmup": warmup, "wall_seconds": state["wall_seconds"],
        "divergence_rate": float(state["diverging"].double().mean()),
        "max_rhat": float(np.nanmax(r)),
        "min_ess": float(np.nanmin(e)),
        "median_ess": float(np.nanmedian(e)),
        "mass": "hessian" if mass_from is None else f"emp_var:{mass_from}", "init": init_src,
        "step_size": float(torch.exp(state["carry"].da.log_eps_avg)),
        "x64": True, "frozen_basis": frozen_basis,
    }


def mode_surrogate_check(params_npz: str, tpu_npz: str, ref_npz: str | None = None, n_points: int = 4,
                         device=None) -> dict:
    """The true bound (float64, a fresh laddered whitening at every
    evaluation, block 64) against the benchmarked surrogate (the whitening
    frozen at the anchor; float64 block 64, and float32 block 32) at the
    anchor, at ``n_points`` draws of ``tpu_npz`` picked by
    ``np.random.default_rng(7)`` as the JAX module picks them, and at the last
    position of up to 4 chains of ``ref_npz``. The JAX module found the
    surrogate equal to the true bound near the anchor and hundreds of nats
    off at the fresh-basis reference's positions: the anchor must be a
    converged optimum."""
    dev = resolve_device(device)
    cfg, p64, Y, U, _, _ = _flagship(0, torch.float64, params_npz, device=dev)
    fresh, flat64, _, _ = make_rgp_potential(cfg, p64, Y, U, block=64, psi_prefer="scan", fixed_whitening=False)
    frozen64 = make_rgp_potential(cfg, p64, Y, U, block=64, psi_prefer="scan", fixed_whitening=True)[0]
    cfg32, p32, Y32, U32, _, _ = _flagship(0, torch.float32, params_npz, device=dev)
    frozen32 = make_rgp_potential(cfg32, p32, Y32, U32, block=32, psi_prefer="scan", fixed_whitening=True)[0]

    pts = {"anchor": flat64.cpu().numpy()}
    d = _draws_of(tpu_npz, flat64.shape[0])
    rng = np.random.default_rng(7)
    for i in rng.choice(d.shape[0], n_points, replace=False):
        pts[f"tpu_draw_{i}"] = d[i]
    if ref_npz is not None:
        with np.load(ref_npz) as z:
            dr = z["draws"]
        for c in range(min(4, dr.shape[0])):
            pts[f"ref_chain{c}_last"] = dr[c, -1]
    rows = []
    with torch.no_grad():
        for k, v in pts.items():
            u_fresh = float(fresh(torch.as_tensor(v, dtype=torch.float64, device=dev)))
            u_fr64 = float(frozen64(torch.as_tensor(v, dtype=torch.float64, device=dev)))
            u_fr32 = float(frozen32(torch.as_tensor(v, dtype=torch.float32, device=dev)))
            rows.append({"point": k, "U_f64_fresh": u_fresh, "U_f64_frozen": u_fr64, "U_f32_frozen": u_fr32,
                         "surrogate_gap": u_fr64 - u_fresh, "dtype_gap": u_fr32 - u_fr64})
    return {"mode": "surrogate-check", "points": rows,
            "max_abs_surrogate_gap": max(abs(r["surrogate_gap"]) for r in rows),
            "max_abs_dtype_gap": max(abs(r["dtype_gap"]) for r in rows)}


def mode_compare(tpu_npz: str, cpu_npz: str) -> dict:
    """:func:`compare_draws` of the two npz files' draws."""
    with np.load(tpu_npz) as z:
        d_t, div_t = z["draws"], z["diverging"]
    with np.load(cpu_npz) as z:
        d_c, div_c = z["draws"], z["diverging"]
    return {"mode": "compare", **compare_draws(d_t, div_t, d_c, div_c)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("fit", "card", "ref", "compare", "surrogate-check"), required=True)
    ap.add_argument("--params", default=_default("pc_params.npz"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--tpu", default=_default("pc_card.npz"), help="the benchmarked sampler's draws")
    ap.add_argument("--cpu", default=_default("pc_ref.npz"), help="the reference's draws")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=96)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--target-accept", type=float, default=0.6,
                    help="below the float32 potential's evaluation-noise acceptance ceiling (~0.72 on the "
                         "flagship in the JAX package's measurement); higher targets death-spiral the dual "
                         "averaging")
    ap.add_argument("--adapt-mass", action="store_true")
    ap.add_argument("--seg", type=int, default=3)
    ap.add_argument("--noise-floor", type=float, default=None,
                    help="override RGPConfig.noise_floor (0.0 matches a reference run on pre-floor code)")
    ap.add_argument("--mass-from", default=None,
                    help="npz of draws whose empirical variance sets the diagonal mass")
    ap.add_argument("--init-from", default=None,
                    help="npz of draws to initialize chains from (ref: chain 0 stays at the anchor)")
    ap.add_argument("--draw-seg", type=int, default=4, help="ref: draws per checkpointed segment")
    ap.add_argument("--frozen-basis", action="store_true",
                    help="ref: matched-policy reference on the frozen-anchor whitened bound")
    ap.add_argument("--fit-iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    if args.mode == "fit":
        out = mode_fit(args.out or _default("pc_params.npz"), args.fit_iters, device=args.device)
    elif args.mode == "card":
        out = mode_card(args.params, args.out or _default("pc_card.npz"), args.chains, args.warmup, args.samples,
                        args.max_depth, args.target_accept, args.group_size, args.seg, args.seed,
                        noise_floor=args.noise_floor, adapt_mass=args.adapt_mass, init_from=args.init_from,
                        mass_from=args.mass_from, device=args.device)
    elif args.mode == "ref":
        out = mode_ref(args.params, args.out or _default("pc_ref.npz"), args.chains, args.warmup, args.samples,
                       args.max_depth, args.target_accept, args.seed, noise_floor=args.noise_floor,
                       mass_from=args.mass_from, init_from=args.init_from, seg=args.seg, draw_seg=args.draw_seg,
                       frozen_basis=args.frozen_basis, device=args.device)
    elif args.mode == "surrogate-check":
        out = mode_surrogate_check(args.params, args.tpu, ref_npz=args.cpu, device=args.device)
    else:
        out = mode_compare(args.tpu, args.cpu)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
