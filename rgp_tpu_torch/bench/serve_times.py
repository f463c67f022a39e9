"""Config-1 serving and step cost on the card, for comparing two checkouts in
one call.

    python3 rgp_tpu_torch/bench/serve_times.py [--root DIR] [--reps N]

``--root`` is the checkout whose ``rgp_tpu_torch`` is timed (default: the one
that holds this file). Only API that the port has had since its training
slice is used (``deep_rgp_config``, ``init_params``, ``freerun``,
``predict_train``, ``compute_whitenings``, ``elbo(whitening=...)``), so an
older checkout unpacked with ``git archive`` can be timed beside this one.
Config 1 in float32 at ``init_params(seed=0)`` (actuator, wins [0,10], M=100,
the 512-step test horizon), one JSON line:

- ``freerun_ms``: each of ``--reps`` freerun calls, host time ending in a
  synchronize, after a warm-up call; ``predict_train_ms`` likewise (4x reps);
- ``freerun_device_ops_per_step`` and ``freerun_device_busy_share``
  (torch.profiler over one freerun call), and ``freerun_host_top``: the host
  ops with the most self time in that call, per step;
- ``step_device_ops``: device ops of one forward and backward of
  ``-elbo`` with the whitening given, as a training step between refreshes
  runs it, and ``step_ops``: those ops by name;
- ``freerun_checksum``: the float64 sum of the freerun means.

The last line names the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn):
    """(device op events, host-op averages, wall us) of one call of ``fn``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in avg if e.device_type == torch.autograd.DeviceType.CPU]
    return dev, host, wall_us


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose rgp_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # before the package is imported: the checkout's own
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    if not torch.cuda.is_available():
        raise SystemExit("serve_times: no CUDA device; this runs on the card only")
    if not rgp.__file__.startswith(root):
        raise SystemExit(f"serve_times: imported {rgp.__file__}, not the package under {root}")
    d = datasets.standardized_tensors(datasets.actuator(), dtype=torch.float32)
    Y, U, Ut = d.Y, d.U, d.U_test
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    params = rgp.init_params(cfg, Y, U, seed=0)
    steps = Ut.shape[0]

    with torch.no_grad():
        def fr():
            return rgp.freerun(cfg, params, Y, U, Ut)

        def pt():
            return rgp.predict_train(cfg, params, Y, U)

        fm, _ = fr()
        pt()
        freerun_ms = [_host_ms(fr) for _ in range(args.reps)]
        predict_ms = [_host_ms(pt) for _ in range(4 * args.reps)]
        dev, host, wall_us = _profile(fr)
        whitening = rgp.compute_whitenings(cfg, params, Y, U)

    def step():
        leaves = []

        def track(tree):
            if isinstance(tree, dict):
                return {k: track(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(track(v) for v in tree)
            leaf = tree.detach().requires_grad_()
            leaves.append(leaf)
            return leaf

        p = track(params)
        loss = -rgp.elbo(cfg, p, Y, U, whitening=whitening)
        torch.autograd.grad(loss, leaves)

    step()
    sdev, _, _ = _profile(step)
    top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    print(json.dumps({
        "root": root,
        "freerun_steps": int(steps),
        "freerun_ms": freerun_ms,
        "freerun_ms_median": statistics.median(freerun_ms),
        "predict_train_ms": predict_ms,
        "predict_train_ms_median": statistics.median(predict_ms),
        "freerun_device_ops_per_step": sum(e.count for e in dev) / steps,
        "freerun_device_busy_share": sum(e.self_device_time_total for e in dev) / wall_us,
        "freerun_host_top": [{"name": e.key[:60], "self_us_per_step": e.self_cpu_time_total / steps,
                              "count_per_step": e.count / steps} for e in top],
        "step_device_ops": sum(e.count for e in sdev),
        "step_ops": {e.key[:60]: e.count for e in sorted(sdev, key=lambda e: -e.count)},
        "freerun_checksum": float(fm.double().sum()),
    }))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "card": card}))


if __name__ == "__main__":
    main()
