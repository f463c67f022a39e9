"""Layer-step benchmark: windowed gather -> psi-statistics -> bound (the
twin of ``rgp_tpu/bench/layer_step.py``).

Is the unfused lag-window gather free next to the psi-statistics? At the
flagship (T, M) = (512, 100) and the production (2048, 256) shapes, a
one-hidden-layer RGP times two losses, forward and backward:

  (a) the full REVARB layer step, ``-rgp.elbo``: lag-window gather from the
      q(X) moments, Psi1/Psi2, the whitened collapsed bounds, entropy and KL;
  (b) the same two collapsed bounds (hidden and output layer) on windows
      materialized once outside the timed region, with q(X) and Y entering
      as constants, so the backward covers the hyperparameters and Z, the
      part the gather cannot touch (:func:`layer_losses`).

(a) - (b) is the cost of the gather and the REVARB terms. Both layers take
uncertain inputs, so on float32 CUDA each loss launches K1 and K2 once a
layer a call: at the production shape the hidden layer is (T, M, Q) =
(2048, 256, 32).

Each loss's forward and backward runs ``iters`` times back to back between
two CUDA events, with one synchronize at the end (wall ms). Eager PyTorch
dispatches every op from the host, and the device sits idle between them,
so the answer is read on device time: one trace of the card alone over the
same calls gives the device ms and device ops an iteration
(:func:`rgp_tpu_torch.bench.psi2_times.card_window`), and
``gather_overhead_pct`` is the device-time share, with the wall-time share
beside it (``gather_overhead_pct_wall``). The JAX module amortized dispatch
inside ``lax.scan`` and perturbed the carry against loop-invariant code
motion; eager PyTorch has neither.

    python -m rgp_tpu_torch.bench.layer_step [--iters 200]

One JSON line per shape. It runs on the card unless given ``--device cpu``
(no device time there).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.windows import current_window
from ..device import resolve_device
from ..inference.collapsed_vi import collapsed_bound
from ..models import rgp
from ..ops import psi_stats
from ..ops.cuda import psi2
from ..params import leaves_with_paths, with_leaves
from .sampling import _card

__all__ = ["layer_losses", "run_shape", "main"]


def layer_losses(cfg, params, Y, U):
    """The two losses of :func:`run_shape`: (full, premat, premat_params).

    ``full(params) = -rgp.elbo(cfg, params, Y, U)``; ``premat((kp, op))`` is
    minus the hidden layer's and the output layer's collapsed bounds (block
    128) on windows of the q(X) moments of ``params``, materialized here
    once and detached; ``premat_params = (kp, op)``, each layer's
    ``{"kern", "Z", "log_noise"}`` taken from ``params``."""
    spec = cfg.layers[0]
    with torch.no_grad():
        mus, lams = rgp._hidden_moments(cfg, params, Y, U)
        X_mu, X_s = rgp._layer_inputs(cfg, 0, mus[0], lams[0], None, None, U)
        tgt_mu, tgt_lam = mus[0][spec.win:], lams[0][spec.win:]
        Xo_mu = current_window(tgt_mu, cfg.out_win)
        Xo_s = current_window(tgt_lam, cfg.out_win)

    def full(p):
        return -rgp.elbo(cfg, p, Y, U)

    def premat(both):
        kp, op = both
        stats = psi_stats.psi_statistics(spec.kernel, kp["kern"], kp["Z"], X_mu, X_s, block=128)
        t = collapsed_bound(spec.kernel, kp["kern"], kp["Z"], kp["log_noise"], stats, tgt_mu, tgt_lam)
        so = psi_stats.psi_statistics(cfg.out_kernel, op["kern"], op["Z"], Xo_mu, Xo_s, block=128)
        t = t + collapsed_bound(cfg.out_kernel, op["kern"], op["Z"], op["log_noise"], so, Y)
        return -t

    lp, opar = params["layers"][0], params["out"]
    kp = {"kern": lp["kern"], "Z": lp["Z"], "log_noise": lp["log_noise"]}
    op = {"kern": opar["kern"], "Z": opar["Z"], "log_noise": opar["log_noise"]}
    return full, premat, (kp, op)


def _fwd_bwd(loss, tree):
    """A call of ``loss``'s forward and backward with respect to every leaf
    of ``tree``."""
    leaves = [x.detach().clone().requires_grad_() for _, x in leaves_with_paths(tree)]
    t = with_leaves(tree, leaves)
    return lambda: torch.autograd.grad(loss(t), leaves)


def _measure(fn, dev, iters):
    """{"wall_ms", "device_ms", "device_ops", "k1", "k2", "plain_psi2"} an
    iteration of ``iters`` back-to-back calls after a warm-up call: the
    launches counted over those calls."""
    from .psi2_times import back_to_back_ms

    n1, n2, n0 = psi2.launches, psi2.bwd_launches, psi_stats.plain_psi2_calls
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = back_to_back_ms(fn, dev, iters)
    calls = iters + 1
    row = {"wall_ms": wall, "k1": (psi2.launches - n1) / calls, "k2": (psi2.bwd_launches - n2) / calls,
           "plain_psi2": (psi_stats.plain_psi2_calls - n0) / calls,
           "device_ms": "not measured", "device_ops": "not measured"}
    if dev.type == "cuda":
        from .psi2_times import card_window

        row["device_ms"], row["device_ops"], _ = card_window(fn, iters)
    return row


def run_shape(T: int, M: int, win: int, u_win: int, iters: int = 200, seed: int = 0, device=None) -> dict:
    """One-hidden-layer RGP at (T, M) with windowed input dim win + u_win, in
    float32 on ``device`` (None: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Y = torch.as_tensor(rng.standard_normal((T, 1)), dtype=torch.float32, device=dev)
    U = torch.as_tensor(rng.standard_normal((T, 1)), dtype=torch.float32, device=dev)
    cfg = rgp.deep_rgp_config(wins=[0, win], u_win=u_win, y_dim=1, u_dim=1, num_inducing=M)
    params = rgp.init_params(cfg, Y, U, seed=seed, dtype=torch.float32, device=dev)
    full, premat, premat_params = layer_losses(cfg, params, Y, U)
    a = _measure(_fwd_bwd(full, params), dev, iters)
    b = _measure(_fwd_bwd(premat, premat_params), dev, iters)

    def share(x, y):
        return 100.0 * (x - y) / x if isinstance(x, float) and isinstance(y, float) else "not measured"

    backend, card = _card(dev)
    return {
        "T": T, "M": M, "Q": cfg.layers[0].kernel.input_dim,
        "full_layer_step_ms": a["wall_ms"],
        "premat_bound_ms": b["wall_ms"],
        "gather_and_revarb_terms_ms": a["wall_ms"] - b["wall_ms"],
        "gather_overhead_pct": share(a["device_ms"], b["device_ms"]),
        "gather_overhead_pct_wall": share(a["wall_ms"], b["wall_ms"]),
        "full_layer_step_device_ms": a["device_ms"],
        "premat_bound_device_ms": b["device_ms"],
        "device_ops_per_iter": {"full": a["device_ops"], "premat": b["device_ops"]},
        "launches_per_iter": {"full": {"k1": a["k1"], "k2": a["k2"], "plain_psi2": a["plain_psi2"]},
                              "premat": {"k1": b["k1"], "k2": b["k2"], "plain_psi2": b["plain_psi2"]}},
        "iters": iters,
        "backend": backend,
        "card": card,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    rows = [
        run_shape(512, 100, win=10, u_win=10, iters=args.iters, device=args.device),  # flagship
        run_shape(2048, 256, win=16, u_win=16, iters=args.iters, device=args.device),  # production
    ]
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
