"""Fit the model that a rollout cell serves, with the plain reference alone.

    python3 -m benchmark.fit_served_model --config rgp2mlp-drives-M100 --out FILE [--iters 1000] [--seed 0]

An MPC planner scores candidates with a fitted model: an unfitted one, with
unit lengthscales over 12-20 standardized inputs, predicts the prior
whatever its inputs are, and neither a planner nor a check could tell its
candidates apart. This fits the configuration's model on its record in
float64 with ``reference.py`` (Adam under a cosine decay to 1% of 1e-2, the
whitening bases refreshed every 100 steps, every ladder decided by its own
factorization), starting from the parameters ``inputs.init_params`` makes
from ``--seed``, and writes the leaves in float32 to an npz keyed by their
paths. The configuration file names the npz (``served_params``); a run
reads it as data, and the program never produced it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import inputs
from . import reference as ref
from .run import HERE


def fit(cfg, iters, seed, device, lr=1e-2):
    rec = inputs.record(cfg, torch.float64, device, T=cfg.get("T"))
    params = inputs.member(inputs.init_params(cfg, rec, 1, inputs.generator(seed, device), torch.float64), 0)
    names = [p for p, _ in ref.tree_leaves(params)]
    x = [t.detach() for _, t in ref.tree_leaves(params)]
    m = [torch.zeros_like(t) for t in x]
    v = [torch.zeros_like(t) for t in x]
    losses = []
    for i in range(iters):
        if i % 100 == 0:
            bases = [bs[0] for bs in ref.refresh(cfg, ref.tree_with(params, x), rec.Y, rec.U, ref.Ladder(None))]
        leaves = [t.clone().requires_grad_(True) for t in x]
        (_, loss), = ref.neg_elbo(cfg, ref.tree_with(params, leaves), rec.Y, rec.U, bases, ladder=ref.Ladder(None))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(t) if gi is None else gi for t, gi in zip(leaves, g)]
        x, m, v = ref.adam_step(x, g, m, v, i, ref.cosine_lr(lr, iters, 0.01, i))
        losses.append(float(loss.detach()))
    return dict(zip(names, (t.float().cpu().numpy() for t in x))), losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    leaves, losses = fit(cfg, args.iters, args.seed, dev)
    np.savez(args.out, **leaves)
    print(json.dumps({"config": args.config, "iters": args.iters, "seed": args.seed, "loss_first": losses[0],
                      "loss_last": losses[-1], "seconds": time.perf_counter() - t0, "device": str(dev)}))


if __name__ == "__main__":
    main()
