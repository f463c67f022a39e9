"""The comparison that decides ``correct``: what the window's own calls
produced, at the timed sizes, against the plain reference (``reference.py``)
run in float64 on the same inputs once the window has closed.

Rollout: a sample of the window's requests, and of candidates in each, drawn
from the seed once the window has closed. The widest gap of a predicted
mean in predictive standard deviations, and of a predicted variance relative
to the reference's.

Every rung that float32 rounding can reach is a branch of the reference
(``reference.Ladder``); the program is held to the nearest branch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs
from . import reference as ref


def _f64(tree):
    return inputs.tree_map(lambda x: x.detach().to(torch.float64), tree)


def _finite(x):
    """A gap, with a NaN or an infinity read as an infinite gap."""
    x = float(x)
    return x if np.isfinite(x) else float("inf")


def rollout_sample(n_requests, width, traffic, seed):
    """(request indices, candidate indices for each) drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    reqs = np.sort(rng.choice(n_requests, size=min(n_requests, traffic["check_requests"]), replace=False))
    return [(int(i), np.sort(rng.choice(width, size=traffic["check_candidates"], replace=False))) for i in reqs]


def rollout_check(cfg, traffic, limits, record, params, rec, seed):
    band, lim = limits["ladder"], limits["limits"]
    outs = record["outs"]
    picks = rollout_sample(len(outs), traffic["width"], traffic, seed)
    Us = torch.cat([outs[i][0][c] for i, c in picks]).double()
    mp = torch.cat([outs[i][1][c] for i, c in picks]).double()
    vp = torch.cat([outs[i][2][c] for i, c in picks]).double()
    ladder = ref.Ladder(band)
    branches = ref.rollout_branches(cfg, _f64(params), rec.Y.double(), rec.U.double(), Us, ladder)
    best = None
    for rungs, mr, vr in branches:
        mean_gap = _finite(((mp - mr).abs() / torch.sqrt(vr)).max())
        var_gap = _finite(((vp - vr).abs() / vr).max())
        score = max(mean_gap / lim["mean_gap"], var_gap / lim["var_gap"])
        if best is None or score < best[0]:
            best = (score, mean_gap, var_gap, rungs)
    _, mean_gap, var_gap, rungs = best
    margins = [abs(t.margin) for t in ladder.trials]
    notes = {"requests_compared": [i for i, _ in picks], "sequences": int(Us.shape[0]),
             "branches": len(branches), "ambiguous_trials": sum(len(t.outcomes) > 1 for t in ladder.trials),
             "trials": len(ladder.trials), "least_margin": min(margins) if margins else None,
             "rungs": [list(x) for x in rungs]}
    return {"mean_gap": mean_gap, "var_gap": var_gap}, notes


CHECKS = {"rollout": rollout_check}
