#!/usr/bin/env python3
"""Where a batch of config-1 restarts parts from the same restarts one at a
time in float32: the eighs and Cholesky factorizations, traced.

At each seed's ``init_params`` of config 1 (actuator, M=100, float32) a
recording dispatch mode logs every eigh and every ``cholesky_ex`` with its
input and outcome while

* the whitening bases are formed by ``rgp.compute_whitenings`` under
  ``torch.func.vmap`` over the stacked restarts and for each restart alone
  (one eigh and two floor-ladder trial Cholesky factorizations a layer), and
* the bound is evaluated at each restart's own bases, under ``vmap``
  (``config1.restart_losses``) and for each restart alone (per layer, the
  Cholesky jitter ladders of Kt and of Ct: a trial at x1, one at x1e3, then
  the factorization at the rung chosen).

For each factorization, in call order, and each restart: the outcome
(``info``) on both paths, the largest gap between the two paths' input
matrices, and the other path's factorization run on each input (the batched
Cholesky on the single inputs, the single Cholesky on the batched input),
which says whether an outcome follows the matrix or the factorization. Before
them, the gaps of each layer's Kmm and Psi2 and of the eighs' eigenvalues.
Then each restart's loss at its vmapped bases, at its own bases, and under
``vmap`` at its own bases, with the number of output-layer directions each
basis tops up (a higher floor rung tops up more). Last, ``--steps`` Adam steps
of the batch twice, refreshing the bases under ``vmap`` and through
``config1.restart_whitenings`` (``config1.fit_batched``): each restart's
final ELBO both ways. One JSON line each; the card's name and power limit
last. Needs a CUDA device.

    python3 tools/batched_whitening.py [--restarts 8] [--steps 200]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from rgp_tpu_torch import train  # noqa: E402
from rgp_tpu_torch.bench import config1  # noqa: E402
from rgp_tpu_torch.models import rgp  # noqa: E402

F32 = torch.float32
_ATEN = torch.ops.aten
_OPS = {_ATEN._linalg_eigh.default: "eigh", _ATEN.linalg_cholesky_ex.default: "cholesky"}


class Record(TorchDispatchMode):
    """Logs (op, input, outputs) of every eigh and Cholesky that runs inside
    it; under ``vmap`` the input carries the restart axis first."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _OPS:
            self.calls.append((_OPS[func], args[0].detach().clone(), [o.detach().clone() for o in out]))
        return out


def recorded(fn):
    """(fn(), the calls it made: {"eigh": [...], "cholesky": [...]})."""
    with torch.no_grad(), Record() as rec:
        out = fn()
    return out, {k: [c[1:] for c in rec.calls if c[0] == k] for k in _OPS.values()}


def gap(a, b):
    return float((a - b).abs().max())


def factorizations(part, labels, batched, singles):
    """One line a Cholesky: both paths' outcomes and inputs, crossed."""
    R = len(singles)
    if not len(batched) == len(labels) == len(singles[0]):
        raise SystemExit(f"{part}: {len(batched)} batched and {len(singles[0])} single factorizations, "
                         f"want {len(labels)}")
    for i, (label, (Xb, (_, info_b))) in enumerate(zip(labels, batched)):
        Xs = torch.stack([s[i][0] for s in singles])
        print("cholesky", json.dumps({
            "part": part, "call": i, "what": label, "info_batched": info_b.tolist(),
            "info_single": [int(s[i][1][1]) for s in singles],
            "info_batched_factorization_on_single_inputs": torch.linalg.cholesky_ex(Xs)[1].tolist(),
            "info_single_factorization_on_batched_input": [int(torch.linalg.cholesky_ex(Xb[r])[1])
                                                           for r in range(R)],
            "input_gap": [gap(Xb[r], Xs[r]) for r in range(R)],
            "input_max": [float(Xs[r].abs().max()) for r in range(R)]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    R = args.restarts
    if not torch.cuda.is_available():
        raise SystemExit("batched_whitening: no CUDA device")
    cfg, _, Y, U, _, _, _ = config1.setup(F32)
    n_layers = cfg.n_hidden + 1
    inits = [rgp.init_params(cfg, Y, U, seed=s, dtype=F32, device=Y.device) for s in range(R)]
    stacked = config1.stack_restarts(inits)

    with torch.no_grad():
        inputs_b = torch.func.vmap(lambda p: rgp._whitening_inputs(cfg, p, Y, U, None))(stacked)
        inputs_s = [rgp._whitening_inputs(cfg, p, Y, U, None) for p in inits]
    for h in range(n_layers):
        print("inputs", json.dumps({"layer": h,
                                    "Kmm_gap": [gap(inputs_b[h][0][r], inputs_s[r][h][0]) for r in range(R)],
                                    "psi2_gap": [gap(inputs_b[h][1][r], inputs_s[r][h][1]) for r in range(R)]}))

    # the whitening bases: one eigh and the two floor trials (1e-6, 1e-3) a layer
    vmapped, calls_b = recorded(lambda: torch.func.vmap(
        lambda p: rgp.compute_whitenings(cfg, p, Y, U, block=None))(stacked))
    own, calls_s = zip(*[recorded(lambda: rgp.compute_whitenings(cfg, p, Y, U, block=None)) for p in inits])
    for h, (lam_b, _) in enumerate(c[1] for c in calls_b["eigh"]):
        print("eigh", json.dumps({"layer": h, "eigenvalue_gap": [gap(lam_b[r], calls_s[r]["eigh"][h][1][0])
                                                                 for r in range(R)]}))
    factorizations("whitening", [f"layer {h} floor-ladder trial at {fl}" for h in range(n_layers)
                                 for fl in ("1e-6", "1e-3")],
                   calls_b["cholesky"], [c["cholesky"] for c in calls_s])

    # the bound at each restart's own bases: the Kt and Ct jitter ladders a layer
    own_stacked = tuple(type(ws[0])(*map(torch.stack, zip(*ws))) for ws in zip(*own))
    loss_r, calls_b = recorded(lambda: config1.restart_losses(cfg, stacked, Y, U, own_stacked))
    loss_s, calls_s = zip(*[recorded(lambda: -rgp.elbo(cfg, p, Y, U, block=None, whitening=w))
                            for p, w in zip(inits, own)])
    factorizations("bound", [f"layer {h} {m} jitter ladder, {rung}" for h in range(n_layers) for m in ("Kt", "Ct")
                             for rung in ("trial at x1", "trial at x1e3", "final")],
                   calls_b["cholesky"], [c["cholesky"] for c in calls_s])
    with torch.no_grad():
        loss_b = config1.restart_losses(cfg, stacked, Y, U, vmapped)
        per_restart = config1.restart_whitenings(cfg, stacked, Y, U)
    for r in range(R):
        print("restart", json.dumps({
            "restart": r, "loss_vmapped_bases": float(loss_b[r]), "loss_own_bases": float(loss_s[r]),
            "loss_vmapped_at_own_bases": float(loss_r[r]),
            "restart_whitenings_equal_own_bases": all(
                bool(torch.equal(a[r], b)) for wb, ws in zip(per_restart, own[r]) for a, b in zip(wb, ws)),
            "out_topped_up_vmapped": int((vmapped[-1].topup[r] > 0).sum()),
            "out_topped_up_own": int((own[r][-1].topup > 0).sum())}), flush=True)

    def vmapped_bases(p):
        return torch.func.vmap(lambda q: rgp.compute_whitenings(cfg, q, Y, U, block=None))(p)

    finals = {"vmapped_bases": train.fit_adam(
        lambda p, wh: config1.restart_losses(cfg, p, Y, U, wh), stacked, iters=args.steps,
        learning_rate=train.cosine_decay_schedule(1e-2, args.steps, 0.01), aux_fn=vmapped_bases,
        aux_every=config1.WHITEN_EVERY).losses[-1],
        "restart_whitenings": config1.fit_batched(cfg, stacked, Y, U, args.steps, 1e-2).losses[-1]}
    print("runs", json.dumps({"steps": args.steps, "final_elbos": {k: (-v).double().cpu().tolist()
                                                                    for k, v in finals.items()}}), flush=True)
    print(json.dumps({"card": config1.card(), "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
