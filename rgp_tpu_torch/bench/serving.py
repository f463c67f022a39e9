"""Serving-path benchmark: closed-loop simulation and one-step prediction (the
twin of ``rgp_tpu/bench/serving.py``).

On the flagship config-1 model (``bench.sampling._flagship``):

  * freerun steps/s and latency over the 512-step test horizon: one
    ``rgp.freerun`` request, the posteriors computed once, then one
    moment-matched step at a time from the host;
  * one-step-ahead ``predict_train`` latency over the training span;
  * batched serving at width ``--batch``: ``torch.func.vmap`` of
    ``rgp.freerun`` over that many copies of the test inputs, each perturbed
    by 0.01 of a standard normal from a seeded ``torch.Generator`` on the
    card. The posteriors take the unbatched model, so they run once (K1 once
    a layer); the steps run batched. The aggregate steps/s is the card's
    serving throughput.

Each timing ends in ``torch.cuda.synchronize`` (the JAX module's host-read
barrier). The last line of standard output is one JSON object with the JAX
benchmark's keys; ``details`` also names the card and its power limit.

    python -m rgp_tpu_torch.bench.serving [--fit-iters 300] [--repeat 20] [--batch 64]

The command line runs on the card only; :func:`serve` takes a model on any
device. ``bench/serve_times.py`` compares the serving path of two checkouts.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import rgp
from .sampling import _card, _flagship

__all__ = ["perturbed_inputs", "batched_freerun", "serve", "main"]


def perturbed_inputs(U_test, batch: int):
    """(batch, T*, Du): ``U_test`` plus 0.01 of standard normals drawn from a
    ``torch.Generator`` on its device seeded with 0."""
    gen = torch.Generator(U_test.device).manual_seed(0)
    noise = torch.randn((batch, *U_test.shape), generator=gen, dtype=U_test.dtype, device=U_test.device)
    return U_test[None] + 0.01 * noise


def batched_freerun(cfg, params, Y, U, Us):
    """``rgp.freerun`` of each of the (B, T*, Du) input sequences ``Us``,
    under ``torch.func.vmap``: (means (B, T*, Dy), variances (B, T*, Dy))."""
    with torch.no_grad():
        return torch.func.vmap(lambda u: rgp.freerun(cfg, params, Y, U, u))(Us)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, repeat: int = 20, batch: int = 64, return_outputs: bool = False):
    """The serving record of ``model`` = (cfg, params, Y, U, U_test, ...) as
    ``_flagship`` returns it: each latency the mean of ``repeat`` requests
    after an untimed one (the batched one over ``max(1, repeat // 4)``).
    ``return_outputs``: also return the timed batched freerun's (means,
    variances) and its inputs."""
    cfg, params, Y, U, Ut = model[:5]
    dev = Y.device
    T_star = int(Ut.shape[0])

    def timed(fn, n):
        with torch.no_grad():
            fn()  # untimed: allocator, cuBLAS/cuSOLVER set-up
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn()
            _sync(dev)
        return (time.perf_counter() - t0) / n, out

    dt_free, _ = timed(lambda: rgp.freerun(cfg, params, Y, U, Ut), repeat)
    dt_one, _ = timed(lambda: rgp.predict_train(cfg, params, Y, U), repeat)
    Us = perturbed_inputs(Ut, batch)
    dt_batch, out = timed(lambda: batched_freerun(cfg, params, Y, U, Us), max(1, repeat // 4))
    backend, card = _card(dev)
    record = {
        "metric": f"freerun_steps_per_sec[rgp1L_actuator_M100_T{T_star}]",
        "value": T_star / dt_free,
        "unit": "steps/s",
        "vs_baseline": None,
        "details": {
            "backend": backend,
            "card": card,
            "horizon_steps": T_star,
            "freerun_latency_ms": dt_free * 1e3,
            "onestep_predict_latency_ms": dt_one * 1e3,
            "batched_serving_width": batch,
            "batched_serving_steps_per_sec": batch * T_star / dt_batch,
            "batched_serving_latency_ms": dt_batch * 1e3,
            "repeat": repeat,
            "moment_matched": True,
        },
    }
    return (record, out, Us) if return_outputs else record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fit-iters", type=int, default=300)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64, help="batched-serving width (vmapped closed-loop sims)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving: no CUDA device; this benchmark runs on the card only")
    print(json.dumps(serve(_flagship(args.fit_iters, torch.float32), args.repeat, args.batch)))


if __name__ == "__main__":
    main()
