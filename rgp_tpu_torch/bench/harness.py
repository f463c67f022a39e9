"""Benchmark harness: task x method registries and free-simulation scoring
(port of ``rgp_tpu/bench/harness.py``, configs 2-4).

Every method trains on the task's train split and is scored by closed-loop
free-simulation RMSE on the held-out split in the original data scale.

    python -m rgp_tpu_torch.bench --task drives --method rgp2_mlp --iters 300
    python -m rgp_tpu_torch.bench --task actuator --method gp_narx --iters 1000 --num-inducing 50
    python -m rgp_tpu_torch.bench --task long_corpus --method svgp_natgrad --iters 1000 --batch-size 512

Config 4's routes on ``long_corpus`` (a NARX design of 12278 x 15 at the
defaults): ``svgp_natgrad`` (minibatch SVI, Adam plus natural-gradient q(u)),
``svgp_natgrad_collapsed`` (the same fit, scored through the exact collapsed
posterior), ``gp_narx_minibatch`` and ``gp_narx_minibatch_ema`` (the
collapsed bound from T/B-scaled batch statistics, raw or EMA-smoothed) and
``gp_narx_collapsed`` (the full-corpus collapsed bound every step).

The last line of standard output is one JSON object with the JAX harness's
keys; ``backend`` is the card's name. It runs on the card: ``run`` takes
``device="cpu"`` for the tests, and the command line has no CPU mode.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from .. import train
from ..data import datasets
from ..data.windows import Standardizer
from ..kernels import RBF, Matern52
from ..data.windows import narx_design
from ..inference.collapsed_vi import collapsed_bound, collapsed_bound_from_suffstats, whitening_basis
from ..linalg import hdot
from ..models import gp_narx, rgp, sparse_gp, svgp
from ..ops.psi_stats import psi01, psi_statistics
from ..params import positive

__all__ = ["TASKS", "METHODS", "MethodFit", "run", "main"]

TASKS: Dict[str, Callable] = {
    "actuator": datasets.actuator,
    "drives": datasets.drives,
    "narendra": datasets.narendra,
    "ballbeam": datasets.ballbeam,
    "dryer": datasets.dryer,
    "gas_furnace": datasets.gas_furnace,
    "tanks": datasets.tanks,
    "long_corpus": datasets.long_corpus,
}

@dataclasses.dataclass
class _Prepared:
    Y: torch.Tensor
    U: torch.Tensor
    U_test: torch.Tensor
    y_test_raw: np.ndarray
    sy: Standardizer


def _prepare(task: str, dtype=torch.float32, device=None, **task_kw) -> _Prepared:
    d = TASKS[task](**task_kw)
    t = datasets.standardized_tensors(d, dtype=dtype, device=device)
    return _Prepared(Y=t.Y, U=t.U, U_test=t.U_test, y_test_raw=np.asarray(d.y_test), sy=t.sy)


# ------------------------------------------------------------------ methods


class MethodFit(NamedTuple):
    """What a method returns: the training result, the free simulation's means and
    variances over the test split (standardized scale), ``val_fn()`` (a cheap
    closed-loop rollout RMSE over the last ``_val_horizon`` steps of the
    training split: the restart score of ``run(select="rollout")``), the
    model's config, the loss it minimized (``loss(params)``, ``loss(params,
    aux)`` for a full-data route with a whitening ``aux``, ``loss(params,
    batch)`` for a minibatch route), and ``freerun()``, which reruns the free
    simulation that gave the means and variances."""

    res: train.FitResult
    means: torch.Tensor
    vars: torch.Tensor
    val_fn: Callable[[], float]
    cfg: Any
    loss: Callable
    freerun: Callable[[], tuple]


def _method_fit(res, freerun, val_fn, cfg, loss) -> MethodFit:
    m, v = freerun()
    return MethodFit(res, m, v, val_fn, cfg, loss, freerun)


def _val_horizon(T: int) -> int:
    return min(128, T // 4)


def _std_rmse(m, target) -> float:
    return float(torch.sqrt(((m - target) ** 2).mean()))


def _adam(loss, params, iters, lr):
    return train.fit_adam(loss, params, iters=iters,
                          learning_rate=train.cosine_decay_schedule(lr, iters, 0.01))


def _method_gp_narx(prep: _Prepared, iters: int, lr: float, seed: int, M: int,
                    kernel_cls=RBF, moment_match: bool = True,
                    ls_prior_std: float | None = None, noise_floor: float = 1e-4):
    """``ls_prior_std``: optional N(0, std^2) prior on the log-lengthscales;
    ``noise_floor``: the floor on the noise variance."""
    cfg = gp_narx.NARXConfig(kernel=kernel_cls(input_dim=15), num_inducing=M,
                             y_win=10, u_win=5, noise_floor=noise_floor)
    params = gp_narx.init_params(cfg, prep.Y, prep.U, noise=0.1, seed=seed,
                                 dtype=prep.Y.dtype, device=prep.Y.device)

    def loss(p):
        f = -gp_narx.elbo(cfg, p, prep.Y, prep.U)
        if ls_prior_std is not None:
            f = f + 0.5 * ((p["kern"]["log_ls"] / ls_prior_std) ** 2).sum()
        return f

    res = _adam(loss, params, iters, lr)

    @torch.no_grad()
    def freerun():
        return gp_narx.freerun(cfg, res.params, prep.Y, prep.U, prep.U_test,
                               y_init=prep.Y[-10:], moment_match=moment_match)

    @torch.no_grad()
    def val_fn():
        T = prep.Y.shape[0]
        K = _val_horizon(T)
        mv, _ = gp_narx.freerun(
            cfg, res.params, prep.Y[: T - K], prep.U[: T - K], prep.U[T - K:],
            y_init=prep.Y[T - K - cfg.y_win: T - K], moment_match=moment_match,
        )
        return _std_rmse(mv, prep.Y[T - K:])

    return _method_fit(res, freerun, val_fn, cfg, loss)


def _truncate_rgp_params(params, K: int):
    """Drop the last ``K`` steps of every per-layer q(X) sequence so
    ``rgp.freerun`` rolls out from time T-K of the training span."""
    p = dict(params)
    p["layers"] = [
        {k: (v[:-K] if k in ("mu", "log_lam") else v) for k, v in lp.items()}
        for lp in params["layers"]
    ]
    return p


def _method_rgp(prep, iters, lr, seed, M, wins, back_cstr=False, mlp=()):
    cfg = rgp.deep_rgp_config(
        wins=wins, u_win=10, y_dim=prep.Y.shape[1], u_dim=prep.U.shape[1],
        num_inducing=M, back_cstr=back_cstr, mlp_hidden=mlp,
    )
    params = rgp.init_params(cfg, prep.Y, prep.U, seed=seed, dtype=prep.Y.dtype,
                             device=prep.Y.device)

    def loss(p):
        return -rgp.elbo(cfg, p, prep.Y, prep.U)

    res = _adam(loss, params, iters, lr)

    @torch.no_grad()
    def freerun():
        return rgp.freerun(cfg, res.params, prep.Y, prep.U, prep.U_test)

    @torch.no_grad()
    def val_fn():
        T = prep.Y.shape[0]
        K = _val_horizon(T)
        # with back-constraints the encoder re-derives means from the sliced
        # Y/U; the free log_lam sequence still needs the slice to stay aligned
        pv = _truncate_rgp_params(res.params, K)
        mv, _ = rgp.freerun(cfg, pv, prep.Y[: T - K], prep.U[: T - K], prep.U[T - K:])
        return _std_rmse(mv, prep.Y[T - K:])

    return _method_fit(res, freerun, val_fn, cfg, loss)


def _floored(log_noise, noise_floor):
    """The raw log-noise whose noise is ``positive(log_noise) + noise_floor``."""
    return torch.log(torch.expm1(positive(log_noise) + noise_floor))


# config 4's NARX windows (rgp_tpu/bench/harness.py's y_win, u_win)
_C4_Y_WIN, _C4_U_WIN = 10, 5


def _narx_scored(res, ncfg, p, prep: _Prepared, cfg, loss) -> MethodFit:
    """A config-4 fit scored through ``gp_narx.freerun`` of ``ncfg`` at ``p``
    (the exact full-data collapsed posterior), on the test split and, for
    ``val_fn``, on the training tail."""

    @torch.no_grad()
    def freerun():
        return gp_narx.freerun(ncfg, p, prep.Y, prep.U, prep.U_test, y_init=prep.Y[-_C4_Y_WIN:])

    @torch.no_grad()
    def val_fn():
        T = prep.Y.shape[0]
        K = _val_horizon(T)
        mv, _ = gp_narx.freerun(ncfg, p, prep.Y[: T - K], prep.U[: T - K], prep.U[T - K:],
                                y_init=prep.Y[T - K - _C4_Y_WIN: T - K])
        return _std_rmse(mv, prep.Y[T - K:])

    return _method_fit(res, freerun, val_fn, cfg, loss)


def _c4_design(prep: _Prepared):
    return narx_design(prep.Y, prep.U, _C4_Y_WIN, _C4_U_WIN)


def _c4_schedule(value: float, iters: int, alpha: float):
    """Cosine decay with its horizon pinned at 10k steps whatever the budget:
    stretching it with ``iters`` keeps both rates high for longer, and the
    JAX package measured the run destabilizing at 30k."""
    return train.cosine_decay_schedule(value, min(iters, 10000), alpha)


def _method_svgp_natgrad(prep: _Prepared, iters: int, lr: float, seed: int, M: int,
                         batch_size: int = 512, noise_floor: float = 1e-4,
                         collapse_eval: bool = False, indices=None):
    """Config 4: minibatch SVI on the NARX windows, Adam (clipped at global
    norm 10, cosine to 1%) on the hyperparameters and Z, a natural-gradient
    step on q(u) after each (cosine 0.1 -> 0.005); the loss and the scored
    model carry the explicit noise floor. ``collapse_eval`` scores the learned
    (kern, Z, noise) through the exact full-data collapsed posterior instead
    of the learned q(u). ``indices`` replays given batch draws."""
    X, Yt = _c4_design(prep)
    cfg = svgp.SVGPConfig(RBF(input_dim=X.shape[1]), num_inducing=M, output_dim=Yt.shape[1])
    params = svgp.init_params(cfg, X, noise=0.1, seed=seed, dtype=X.dtype, device=X.device)
    T_total = X.shape[0]
    bs = min(batch_size, T_total)

    def floored(p):
        return {**p, "log_noise": _floored(p["log_noise"], noise_floor)}

    def loss(p, batch):
        return -svgp.elbo(cfg, floored(p), batch["X"], batch["Y"], T_total=T_total)

    res = train.fit_minibatch(
        loss, params, {"X": X, "Y": Yt}, iters=iters, batch_size=bs, seed=seed, indices=indices,
        learning_rate=_c4_schedule(lr, iters, 0.01), clip_norm=10.0,
        natgrad_block="qu", natgrad_lr=_c4_schedule(0.1, iters, 0.05),
    )
    p = floored(res.params)  # the freerun sees the model the loss trained
    if collapse_eval:
        ncfg = gp_narx.NARXConfig(kernel=cfg.kernel, num_inducing=M, y_win=_C4_Y_WIN,
                                  u_win=_C4_U_WIN, noise_floor=0.0)
        pc = {"kern": p["kern"], "Z": p["Z"], "log_noise": p["log_noise"]}
        return _narx_scored(res, ncfg, pc, prep, cfg, loss)

    @torch.no_grad()
    def freerun():
        return svgp.freerun_narx(cfg, p, _C4_Y_WIN, _C4_U_WIN, prep.Y, prep.U, prep.U_test)

    @torch.no_grad()
    def val_fn():
        T = prep.Y.shape[0]
        K = _val_horizon(T)
        mv, _ = svgp.freerun_narx(cfg, p, _C4_Y_WIN, _C4_U_WIN, prep.Y[: T - K], prep.U[: T - K],
                                  prep.U[T - K:])
        return _std_rmse(mv, prep.Y[T - K:])

    return _method_fit(res, freerun, val_fn, cfg, loss)


def _method_narx_collapsed_full(prep: _Prepared, iters: int, lr: float, seed: int, M: int,
                                noise_floor: float = 1e-4):
    """Config 4, exact route: the full-corpus collapsed GP-NARX bound every
    step (certain inputs: Psi2 from the factor Psi1 = K), the explicit noise
    floor in the loss and the scored model, the whitening refreshed every 100
    steps."""
    X, Yt = _c4_design(prep)
    # noise_floor=0 on the config: the floor is explicit here (in the loss and
    # the scored params); the config's own would double it
    cfg = gp_narx.NARXConfig(kernel=RBF(input_dim=X.shape[1]), num_inducing=M, y_win=_C4_Y_WIN,
                             u_win=_C4_U_WIN, noise_floor=0.0)
    params = sparse_gp.init_params(cfg.sparse, X, noise=0.1, seed=seed, dtype=X.dtype, device=X.device)
    kern = cfg.kernel

    def loss(p, wh):
        stats = psi_statistics(kern, p["kern"], p["Z"], X, None)
        return -collapsed_bound(kern, p["kern"], p["Z"], _floored(p["log_noise"], noise_floor), stats, Yt,
                                certain=True, W=wh)

    res = train.fit_adam(loss, params, iters=iters,
                         learning_rate=train.cosine_decay_schedule(lr, iters, 0.01),
                         aux_fn=lambda p: whitening_basis(kern.K(p["kern"], p["Z"])), aux_every=100)
    p = {**res.params, "log_noise": _floored(res.params["log_noise"], noise_floor)}
    return _narx_scored(res, cfg, p, prep, cfg, loss)


def _suffstats(kern, q, Xb, Yb, w):
    """The T/B-scaled additive statistics of a batch (certain inputs:
    Psi2 = Psi1^T Psi1)."""
    psi0_b, psi1_b = psi01(kern, q["kern"], q["Z"], Xb, None)
    return {"psi0": w * psi0_b.sum(), "p1y": w * hdot(psi1_b.T, Yb),
            "psi2": w * hdot(psi1_b.T, psi1_b), "ysq": w * (Yb ** 2).sum()}


def _fit_ema(kern, params, X, Yt, loss_at, iters, bs, seed, indices, learning_rate, ema):
    """The EMA route's own loop (the JAX harness's): each step assembles the
    bound at an exponential moving average of the scaled batch statistics,
    started from the exact full-data statistics at the initial parameters,
    with the gradient flowing through the current batch at full weight
    (straight-through: ``used = b + (new_es - b).detach()``). Clipped cosine
    Adam as the other minibatch routes."""
    T_total = X.shape[0]
    w = T_total / bs
    leaves = [x.detach().clone().requires_grad_(True) for _, x in train.leaves_with_paths(params)]
    q = train.with_leaves(params, leaves)
    opt = train.OptaxAdam(leaves, learning_rate, clip_norm=10.0)
    indices = train.batch_indices(X, iters, bs, seed=seed, indices=indices)
    with torch.no_grad():
        es = _suffstats(kern, params, X, Yt, 1.0)
    losses = torch.empty(iters, dtype=X.dtype, device=X.device)
    keys = sorted(es)
    for i in range(iters):
        idx = indices[i]
        b = _suffstats(kern, q, X[idx], Yt[idx], w)
        new_es = {k: ema * es[k] + (1.0 - ema) * b[k].detach() for k in keys}
        used = {k: b[k] + (new_es[k] - b[k]).detach() for k in keys}
        f = loss_at(q, used)
        grads = torch.autograd.grad(f, leaves)
        losses[i] = f.detach()
        opt.step(grads, i)
        es = new_es
    return train.FitResult(params=train.with_leaves(params, [x.detach() for x in leaves]), losses=losses)


def _method_narx_minibatch(prep: _Prepared, iters: int, lr: float, seed: int, M: int,
                           batch_size: int = 512, noise_floor: float = 1e-4,
                           ema: float | None = None, indices=None):
    """Config 4, collapsed route: the collapsed GP-NARX bound assembled from
    the T/B-scaled statistics of each batch (Psi1's factor sqrt(w) Psi1 keeps
    the whitened Psi2 PSD), clipped cosine Adam, the explicit noise floor in
    the loss and the scored model. With ``ema``, the statistics are smoothed
    (:func:`_fit_ema`). The freerun goes through the exact full-data collapsed
    posterior at the learned hyperparameters. ``indices`` replays given batch
    draws."""
    X, Yt = _c4_design(prep)
    cfg = gp_narx.NARXConfig(kernel=RBF(input_dim=X.shape[1]), num_inducing=M, y_win=_C4_Y_WIN,
                             u_win=_C4_U_WIN, noise_floor=0.0)
    params = sparse_gp.init_params(cfg.sparse, X, noise=0.1, seed=seed, dtype=X.dtype, device=X.device)
    T_total, D = Yt.shape
    bs = min(batch_size, T_total)
    w = T_total / bs
    kern = cfg.kernel
    schedule = _c4_schedule(lr, iters, 0.01)

    def loss(p, batch):
        psi0_b, psi1_b = psi01(kern, p["kern"], p["Z"], batch["X"], None)
        return -collapsed_bound_from_suffstats(
            kern, p["kern"], p["Z"], _floored(p["log_noise"], noise_floor),
            w * psi0_b.sum(), w * hdot(psi1_b.T, batch["Y"]), None, w * (batch["Y"] ** 2).sum(),
            T_total, D, psi1_factor=math.sqrt(w) * psi1_b,
        )

    if ema is None:
        res = train.fit_minibatch(loss, params, {"X": X, "Y": Yt}, iters=iters, batch_size=bs, seed=seed,
                                  indices=indices, learning_rate=schedule, clip_norm=10.0)
    else:
        def loss_at(q, st):
            return -collapsed_bound_from_suffstats(
                kern, q["kern"], q["Z"], _floored(q["log_noise"], noise_floor),
                st["psi0"], st["p1y"], st["psi2"], st["ysq"], T_total, D,
            )

        res = _fit_ema(kern, params, X, Yt, loss_at, iters, bs, seed, indices, schedule, ema)
    p = {**res.params, "log_noise": _floored(res.params["log_noise"], noise_floor)}
    return _narx_scored(res, cfg, p, prep, cfg, loss)


METHODS: Dict[str, Callable] = {
    # **kw carries optional per-run knobs (batch_size and indices for the
    # config-4 minibatch routes, ls_prior_std and noise_floor for gp_narx),
    # forwarded from run()'s method_kw
    "svgp_natgrad": lambda prep, iters, lr, seed, M, **kw: _method_svgp_natgrad(prep, iters, lr, seed, M, **kw),
    # the same fit, scored through the exact full-data collapsed posterior
    "svgp_natgrad_collapsed": lambda prep, iters, lr, seed, M, **kw: _method_svgp_natgrad(
        prep, iters, lr, seed, M, collapse_eval=True, **kw
    ),
    "gp_narx_minibatch": lambda prep, iters, lr, seed, M, **kw: _method_narx_minibatch(
        prep, iters, lr, seed, M, **kw
    ),
    # the minibatch collapsed bound at EMA-smoothed statistics
    "gp_narx_minibatch_ema": lambda prep, iters, lr, seed, M, **kw: _method_narx_minibatch(
        prep, iters, lr, seed, M, ema=kw.pop("ema", 0.99), **kw
    ),
    "gp_narx_collapsed": lambda prep, iters, lr, seed, M, **kw: _method_narx_collapsed_full(
        prep, iters, lr, seed, M
    ),
    "gp_narx": lambda prep, iters, lr, seed, M, **kw: _method_gp_narx(prep, iters, lr, seed, M, **kw),
    "rgp1": lambda prep, iters, lr, seed, M, **kw: _method_rgp(prep, iters, lr, seed, M, [0, 10]),
    "rgp2": lambda prep, iters, lr, seed, M, **kw: _method_rgp(prep, iters, lr, seed, M, [0, 6, 6]),
    "rgp2_mlp": lambda prep, iters, lr, seed, M, **kw: _method_rgp(
        prep, iters, lr, seed, M, [0, 6, 6], back_cstr=True, mlp=(32,)
    ),
    # 1-layer back-constrained control for the depth table
    "rgp1_mlp": lambda prep, iters, lr, seed, M, **kw: _method_rgp(
        prep, iters, lr, seed, M, [0, 10], back_cstr=True, mlp=(32,)
    ),
    # Matern-5/2 GP-NARX: certain-input psi path; freerun plugs in means only
    # (no closed-form moment matching for Matern)
    "gp_narx_matern": lambda prep, iters, lr, seed, M, **kw: _method_gp_narx(
        prep, iters, lr, seed, M, kernel_cls=Matern52, moment_match=False
    ),
}


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, timeout=10,
            cwd=Path(__file__).resolve().parents[2],
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _final_noise_min(params) -> float | None:
    """Min effective raw noise variance over every log_noise leaf: a value
    collapsed to ~0 means the optimizer pinned the model at its floor."""
    vals = [float(positive(leaf)) for path, leaf in train.leaves_with_paths(params)
            if "log_noise" in path]
    return min(vals) if vals else None


def run(
    task: str,
    method: str,
    *,
    iters: int = 10000,
    lr: float = 1e-2,
    seed: int = 0,
    num_inducing: int = 100,
    restarts: int = 1,
    dtype=torch.float32,
    device=None,
    steady: bool = False,
    select: str = "elbo",
    return_fit: bool = False,
    **method_kw,
):
    """Train ``method`` on ``task`` and score its free simulation.

    ``restarts > 1`` runs seeds ``seed, seed+1, ...`` one after another and
    keeps the best by ``select``: "elbo" (final training bound) or "rollout"
    (closed-loop RMSE on the tail of the training split); both scores are
    recorded per restart. ``steady`` runs the method once untimed first
    (kernel builds, allocator and cuSOLVER warm-up), then times a second
    run. ``device=None`` means the card. Returns the JSON-ready record, or
    with ``return_fit`` the pair (record, the kept restart's
    :class:`MethodFit`)."""
    if method not in METHODS:
        raise KeyError(f"unknown method {method!r}; known: {sorted(METHODS)}")
    if select not in ("elbo", "rollout"):
        raise ValueError(f"select must be 'elbo' or 'rollout', got {select!r}")
    prep = _prepare(task, dtype=dtype, device=device)
    if steady:
        out = METHODS[method](prep, iters, lr, seed, num_inducing, **method_kw)
        float(out.res.losses[-1])  # host read: the untimed run has finished
    t0 = time.perf_counter()
    best, table = None, []
    for r in range(restarts):
        out = METHODS[method](prep, iters, lr, seed + r, num_inducing, **method_kw)
        final_elbo = -float(out.res.losses[-1])
        val_rmse = float(out.val_fn()) if (select == "rollout" or restarts > 1) else None
        score = val_rmse if select == "rollout" else -final_elbo
        table.append({"seed": seed + r, "elbo": round(final_elbo, 2),
                      "val_rollout_rmse": round(val_rmse, 5) if val_rmse is not None else None})
        if best is None or score < best[0]:
            best = (score, out)
    fit = best[1]
    res, means = fit.res, fit.means
    float(means[0, 0])  # host read: the timed work has finished
    wall = time.perf_counter() - t0
    m_raw = prep.sy.inverse(means.double().cpu().numpy())
    rmse = float(np.sqrt(np.mean((m_raw - prep.y_test_raw) ** 2)))
    zero = float(np.sqrt(np.mean(prep.y_test_raw ** 2)))
    losses = res.losses.double().cpu().numpy()
    elbo_last = float(-losses[-1])

    # degeneracy flags: standardized data under a >= 1e-4 noise floor caps
    # the per-point log-density at ~3.8 nats, so 10*T*D is generously sane
    T_D = float(np.prod(prep.Y.shape))
    noise_min = _final_noise_min(res.params)
    reasons = []
    if not np.isfinite(elbo_last) or elbo_last > 10.0 * T_D:
        reasons.append("elbo_insane")
    if rmse >= zero:
        reasons.append("freerun_not_better_than_zero")
    if noise_min is not None and noise_min < 1e-5:
        reasons.append("noise_collapsed_to_floor")

    dev = prep.Y.device
    recorded_kw = {k: v for k, v in method_kw.items() if k != "indices"}
    record = {
        "task": task,
        "method": method,
        "iters": iters,
        "freerun_rmse": round(rmse, 5),
        "zero_predictor_rmse": round(zero, 5),
        "elbo_first": round(float(-losses[0]), 2),
        "elbo_last": round(elbo_last, 2),
        "wall_seconds": round(wall, 2),
        "iters_per_sec": round(iters / wall, 2),
        "restarts": restarts,
        "select": select,
        "restart_table": table,
        "steady": steady,
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "git_sha": _git_sha(),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "final_noise_min": None if noise_min is None else float(f"{noise_min:.3g}"),
        "degenerate": bool(reasons),
        "degenerate_reasons": reasons,
        # replayed batch indices (a tensor, for the tests) stay out of the record
        **({"method_kw": recorded_kw} if recorded_kw else {}),
    }
    return (record, fit) if return_fit else record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="actuator", choices=sorted(TASKS))
    ap.add_argument("--method", default="rgp1", choices=sorted(METHODS))
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-inducing", type=int, default=100)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--steady", action="store_true",
                    help="time a second warm run (kernel builds and warm-up excluded)")
    ap.add_argument("--select", default="elbo", choices=("elbo", "rollout"),
                    help="restart selection: final training bound, or "
                         "closed-loop rollout RMSE on the training tail")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="minibatch size for the config-4 methods")
    ap.add_argument("--ls-prior-std", type=float, default=None,
                    help="mild N(0,std^2) prior on log-lengthscales (gp_narx)")
    ap.add_argument("--noise-floor", type=float, default=None,
                    help="noise-variance floor override (gp_narx)")
    args = ap.parse_args(argv)
    kw = {}
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.ls_prior_std is not None:
        kw["ls_prior_std"] = args.ls_prior_std
    if args.noise_floor is not None:
        kw["noise_floor"] = args.noise_floor
    out = run(
        args.task, args.method, iters=args.iters, lr=args.lr, seed=args.seed,
        num_inducing=args.num_inducing, restarts=args.restarts,
        steady=args.steady, select=args.select, **kw,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
