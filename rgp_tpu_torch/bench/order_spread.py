"""How far config 1's float32 training endpoint moves with the order of the
kernels' float32 sums over T.

    python -m rgp_tpu_torch.bench.order_spread [--iters 1000] [--orders 0,1,2,3] [--seeds 0]

K1 and K2 sum over T in ranges (``t_split``, ``bwd_split``), the ranges in
ascending order. Order k trains config 1 as :mod:`.config1` does (one restart
from ``init_params`` of each seed, peak rate 1e-2 with cosine decay, whitening every 100
steps, 20 warm-up steps) with each T range of both kernels k + 1 times as
long as planned: the same kernels, inputs and schedule; only the grouping of
the float32 sums over T differs (order 0 is the planned one). One JSON line per order: the splits
the kernels took, ``(T, M[, Q]) -> (ranges, timesteps a range)``, the seed, ELBO first
and last, the trained freerun RMSE and iterations per second; the last line
names the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import rgp
from ..ops.cuda import psi2
from . import config1

__all__ = ["longer_ranges", "main"]


def _recorded(split, seen, name):
    """``split`` that records each (arguments -> result) it gives under ``name``."""

    def f(*a):
        out = split(*a)
        seen[f"{name}{a}"] = out
        return out

    return f


def longer_ranges(split, k: int):
    """``split`` (a function of (T, ...) -> (n_split, t_per)) with each T
    range ``k + 1`` times as long; the ranges still cover T exactly, and a
    range stays a multiple of whatever ``split`` made it a multiple of."""

    def f(T, *rest):
        _, t_per = split(T, *rest)
        t_per *= k + 1
        return psi2._cdiv(T, t_per), t_per

    return f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--orders", default="0,1,2,3", help="comma-separated k: T ranges k + 1 times as long as planned")
    ap.add_argument("--seeds", default="0", help="comma-separated init seeds, each trained at every order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("order_spread: no CUDA device; this runs on the card only")

    t_split, bwd_split = psi2.t_split, psi2.bwd_split
    for k in (int(x) for x in args.orders.split(",")):
        splits = {}
        psi2.t_split = _recorded(longer_ranges(t_split, k), splits, "k1")
        psi2.bwd_split = _recorded(longer_ranges(bwd_split, k), splits, "k2")
        cfg, _, Y, U, Ut, sy, d = config1.setup(torch.float32)
        for seed in (int(x) for x in args.seeds.split(",")):
            params = rgp.init_params(cfg, Y, U, seed=seed, dtype=Y.dtype, device=Y.device)
            p_fit, losses, ips = config1.timed_fit(cfg, params, Y, U, args.iters, 1e-2)
            with torch.no_grad():
                means, _ = rgp.freerun(cfg, p_fit, Y, U, Ut)
            pred = sy.inverse(means.double().cpu().numpy())
            elbos = (-losses.double()).cpu().numpy()
            print(json.dumps({
                "order": k, "splits": splits, "seed": seed, "iters": args.iters, "iters_per_s": ips,
                "elbo_first": float(elbos[0]), "elbo_last": float(elbos[-1]),
                "freerun_rmse": float(np.sqrt(np.mean((pred - d.y_test) ** 2))),
            }), flush=True)
    psi2.t_split, psi2.bwd_split = t_split, bwd_split
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": config1.card()}))


if __name__ == "__main__":
    main()
