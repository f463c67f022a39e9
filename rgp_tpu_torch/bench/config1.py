"""Config 1 on the card: the port's twin of the root ``bench.py``.

    python -m rgp_tpu_torch.bench.config1 [--iters 10000] [--restarts 8] [--lr 1e-2]

Config 1 (BASELINE.json:7): a 1-layer RGP, RBF-ARD, M=100 inducing points, on
the actuator data, in float32. It trains with Adam on ``-elbo`` under a cosine
decay to 1% of the peak rate, with the spectral whitening bases refreshed
every :data:`WHITEN_EVERY` steps (the schedule of ``bench.py``), then runs
``freerun`` over the test inputs. The last line of standard output is one JSON
object: ELBO iterations per second of one timed training run, its first and
last ELBO, the free-simulation RMSE of the best restart, the zero-predictor
RMSE, and the card's name and power limit.

Restarts train as one batch, as ``bench.py``'s ``_fit_restarts`` vmaps
them (:func:`fit_restarts`): the seeds' parameters stacked leaf by leaf, the
loss ``torch.func.vmap`` of ``-rgp.elbo``, so each layer's Psi2 sum is one K1
launch for all restarts and one K2 launch in the backward; the best final
ELBO is kept behind the degeneracy guard and MAD screen of ``bench.py``.
There is no CPU fallback: without a card this fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import train
from ..data import datasets
from ..inference.collapsed_vi import Whitening, whitening_basis
from ..models import rgp
from ..params import positive
from ..train import restart, stack_restarts

__all__ = ["WHITEN_EVERY", "setup", "fit", "timed_fit", "stack_restarts", "restart_losses", "restart_whitenings",
           "fit_batched", "fit_restarts", "select_restart", "main"]

# whitening-refresh interval of ``bench.py``: the bases are a stop-gradient
# preconditioner, refreshed by ``compute_whitenings`` every this many steps
WHITEN_EVERY = 100


def setup(dtype=torch.float32, device=None):
    """(cfg, params, Y, U, U_test, y standardizer, data) of config 1, as
    ``bench.py``'s ``_setup``; ``device=None`` means the card."""
    d = datasets.load("actuator")
    t = datasets.standardized_tensors(d, dtype=dtype, device=device)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    params = rgp.init_params(cfg, t.Y, t.U, dtype=dtype, device=t.Y.device)
    return cfg, params, t.Y, t.U, t.U_test, t.sy, d


def fit(cfg, params, Y, U, iters: int, lr: float) -> train.FitResult:
    """Adam on ``-elbo`` with a cosine decay to 1% of ``lr`` and a whitening
    refresh every :data:`WHITEN_EVERY` steps."""

    def loss(p, wh):
        return -rgp.elbo(cfg, p, Y, U, block=None, whitening=wh)

    return train.fit_adam(
        loss, params, iters=iters,
        learning_rate=train.cosine_decay_schedule(lr, iters, 0.01),
        aux_fn=lambda p: rgp.compute_whitenings(cfg, p, Y, U, block=None),
        aux_every=WHITEN_EVERY,
    )


def timed_fit(cfg, params, Y, U, iters: int, lr: float, *, warmup: int = 20):
    """:func:`fit`, timed on the host clock between two CUDA synchronizes,
    after ``warmup`` untimed steps (kernel builds, cuSOLVER and allocator
    warm-up). Returns (params, losses, iterations per second)."""
    if warmup:
        fit(cfg, params, Y, U, warmup, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(cfg, params, Y, U, iters, lr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return res.params, res.losses, iters / dt


def select_restart(cfg, elbos, params_list) -> int:
    """Index of the restart to keep: the best final ELBO among restarts that
    pass ``bench.py``'s guard, else the best of all.

    Degeneracy guard: a collapsed hidden-layer noise or q(X) variance channel
    (the classic REVARB failure mode) inflates the float32 ELBO while wrecking
    the closed-loop rollout; such a restart's effective noise sits at the
    floor, or its mean variance below 1e-4. MAD screen: a final ELBO far above
    its cohort's median signals a partially collapsed channel the thresholds
    missed."""
    elbos = np.asarray(elbos, np.float64)
    ok = np.ones(len(elbos), bool)
    for h in range(len(cfg.layers)):
        lps = [p["layers"][h] for p in params_list]
        noise = torch.stack([positive(lp["log_noise"]).reshape(()) for lp in lps]).cpu().numpy()
        lam = torch.stack([torch.exp(lp["log_lam"]).mean() for lp in lps]).cpu().numpy()
        ok &= (noise + cfg.noise_floor) > 1.5 * max(cfg.noise_floor, 1e-4)
        ok &= lam > 1e-4
    med = np.median(elbos)
    mad = np.median(np.abs(elbos - med))
    ok &= elbos <= med + 10.0 * (mad + 1.0)
    score = np.where(ok, elbos, -np.inf)
    return int(np.argmax(score if ok.any() else elbos))


def restart_losses(cfg, stacked, Y, U, whitenings):
    """(R,) ``-rgp.elbo`` of each restart in the stacked tree
    (:func:`rgp_tpu_torch.train.stack_restarts`), at its own whitening bases
    (stacked the same way), under ``torch.func.vmap``."""
    return torch.func.vmap(lambda p, wh: -rgp.elbo(cfg, p, Y, U, block=None, whitening=wh, psi_remat=False))(
        stacked, whitenings)


def restart_whitenings(cfg, stacked, Y, U):
    """Each restart's fresh whitening bases (``rgp.compute_whitenings``),
    stacked (no gradient). The Psi statistics they read run batched under
    ``torch.func.vmap`` (one K1 launch a layer for all restarts); each basis
    is then formed one restart at a time, so that every restart takes the
    spectral-floor rung it takes alone. The rung is the outcome of a float32
    trial Cholesky of the whitened Ct, which at config 1's init sits at the
    edge; formed by batched matmuls, Ct rounds otherwise, and on an H100 the
    output layer's trial then failed for 6 of 8 restarts where the same
    restart's own passed (PERF.md, ROADMAP Queue 3)."""
    with torch.no_grad():
        inputs = torch.func.vmap(lambda p: rgp._whitening_inputs(cfg, p, Y, U, None))(stacked)
        per = [[whitening_basis(*(x[r] for x in layer)) for layer in inputs]
               for r in range(inputs[0][0].shape[0])]
        return tuple(Whitening(*(torch.stack(xs) for xs in zip(*layer))) for layer in zip(*per))


def fit_batched(cfg, stacked, Y, U, iters: int, lr: float) -> train.FitResult:
    """:func:`fit` for every restart of a stacked tree at once:
    :func:`rgp_tpu_torch.train.fit_adam` of :func:`restart_losses` (the
    gradient of their sum is each restart's own, and Adam is elementwise, so
    each restart gets its own update) under the same cosine decay, each
    restart's whitening refreshed every :data:`WHITEN_EVERY` steps
    (:func:`restart_whitenings`). Returns the trained stacked tree and the
    (iters, R) losses."""
    return train.fit_adam(lambda p, wh: restart_losses(cfg, p, Y, U, wh), stacked, iters=iters,
                          learning_rate=train.cosine_decay_schedule(lr, iters, 0.01),
                          aux_fn=lambda p: restart_whitenings(cfg, p, Y, U), aux_every=WHITEN_EVERY)


def fit_restarts(cfg, Y, U, iters: int, lr: float, seeds):
    """``bench.py``'s ``_fit_restarts``: every seed's ``init_params`` in
    ``Y``'s dtype, stacked and trained as one batch (:func:`fit_batched`);
    returns (the kept restart's params, every restart's final ELBO)."""
    stacked = stack_restarts([rgp.init_params(cfg, Y, U, seed=s, dtype=Y.dtype, device=Y.device) for s in seeds])
    res = fit_batched(cfg, stacked, Y, U, iters, lr)
    elbos = (-res.losses[-1]).cpu().numpy()
    params = [restart(res.params, r) for r in range(len(elbos))]
    best = select_restart(cfg, elbos, params)
    return params[best], [float(x) for x in elbos]


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--restarts", type=int, default=8,
                    help="init seeds trained as one batch; best final ELBO kept for the RMSE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("config1: no CUDA device; this benchmark runs on the card only")

    cfg, params, Y, U, Ut, sy, d = setup(torch.float32)
    p_fit, losses, ips = timed_fit(cfg, params, Y, U, args.iters, args.lr)
    finals = None
    if args.restarts > 1:
        p_fit, finals = fit_restarts(cfg, Y, U, args.iters, args.lr, range(args.restarts))
    with torch.no_grad():
        means, _ = rgp.freerun(cfg, p_fit, Y, U, Ut)
    pred = sy.inverse(means.double().cpu().numpy())
    losses = losses.double().cpu().numpy()
    result = {
        "metric": "elbo_iters_per_sec[rgp1L_actuator_M100]",
        "elbo_iters_per_sec": ips,
        "unit": "iter/s",
        "elbo_first": -float(losses[0]),
        "elbo_last": -float(losses[-1]),
        "freerun_rmse_actuator": float(np.sqrt(np.mean((pred - d.y_test) ** 2))),
        "zero_predictor_rmse": float(np.sqrt(np.mean(d.y_test ** 2))),
        "iters": args.iters,
        "restart_final_elbos": finals,
        "device": torch.cuda.get_device_name(0),
        "card": card(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
