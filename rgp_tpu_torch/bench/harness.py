"""Benchmark harness: task x method registries and free-simulation scoring
(port of ``rgp_tpu/bench/harness.py``, configs 1-3).

Every method trains on the task's train split and is scored by closed-loop
free-simulation RMSE on the held-out split in the original data scale.

    python -m rgp_tpu_torch.bench --task drives --method rgp2_mlp --iters 300
    python -m rgp_tpu_torch.bench --task actuator --method gp_narx --iters 1000 --num-inducing 50

The last line of standard output is one JSON object with the JAX harness's
keys; ``backend`` is the card's name. It runs on the card: ``run`` takes
``device="cpu"`` for the tests, and the command line has no CPU mode. The
config-4 methods (``svgp_natgrad*``, ``gp_narx_minibatch*``,
``gp_narx_collapsed``) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import json
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
from ..models import gp_narx, rgp
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

# config 4's routes of the JAX harness, which need svgp, svi, natgrad and the
# minibatch trainers of ROADMAP.md Queue 1 item 12
NOT_PORTED = ("gp_narx_collapsed", "gp_narx_minibatch", "gp_narx_minibatch_ema",
              "svgp_natgrad", "svgp_natgrad_collapsed")


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
    """What a method returns: the Adam result, the free simulation's means and
    variances over the test split (standardized scale), ``val_fn()`` (a cheap
    closed-loop rollout RMSE over the last ``_val_horizon`` steps of the
    training split: the restart score of ``run(select="rollout")``), the
    model's config and the loss it minimized."""

    res: train.FitResult
    means: torch.Tensor
    vars: torch.Tensor
    val_fn: Callable[[], float]
    cfg: Any
    loss: Callable


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
    with torch.no_grad():
        m, v = gp_narx.freerun(cfg, res.params, prep.Y, prep.U, prep.U_test,
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

    return MethodFit(res, m, v, val_fn, cfg, loss)


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
    with torch.no_grad():
        m, v = rgp.freerun(cfg, res.params, prep.Y, prep.U, prep.U_test)

    @torch.no_grad()
    def val_fn():
        T = prep.Y.shape[0]
        K = _val_horizon(T)
        # with back-constraints the encoder re-derives means from the sliced
        # Y/U; the free log_lam sequence still needs the slice to stay aligned
        pv = _truncate_rgp_params(res.params, K)
        mv, _ = rgp.freerun(cfg, pv, prep.Y[: T - K], prep.U[: T - K], prep.U[T - K:])
        return _std_rmse(mv, prep.Y[T - K:])

    return MethodFit(res, m, v, val_fn, cfg, loss)


METHODS: Dict[str, Callable] = {
    # **kw carries optional per-run knobs (ls_prior_std, noise_floor for
    # gp_narx), forwarded from run()'s method_kw
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
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is a config-4 route, not ported yet (ROADMAP.md Queue 1 item 12)"
        )
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
        **({"method_kw": method_kw} if method_kw else {}),
    }
    return (record, fit) if return_fit else record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="actuator", choices=sorted(TASKS))
    ap.add_argument("--method", default="rgp1", choices=sorted(METHODS) + sorted(NOT_PORTED))
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
    ap.add_argument("--ls-prior-std", type=float, default=None,
                    help="mild N(0,std^2) prior on log-lengthscales (gp_narx)")
    ap.add_argument("--noise-floor", type=float, default=None,
                    help="noise-variance floor override (gp_narx)")
    args = ap.parse_args(argv)
    kw = {}
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
