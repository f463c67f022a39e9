"""Device time per call of the Psi2 autograd Function on the card: its
forward (K1) and its backward (K2 and whatever the checkout's backward runs
around it), for comparing two checkouts' kernels in one call.

    python3 rgp_tpu_torch/bench/psi2_times.py [--root DIR]

``--root`` is the checkout whose ``rgp_tpu_torch`` is timed (default: the one
that holds this file). Only what the port has had since its training slice is
used (``kernels.RBF``, ``rbf_psi2_precompute``, ``RBFPsi2Sum``), so an older
checkout unpacked with ``git archive`` can be timed beside this one. At
chip_smoke.py's K1 shapes, from the same seeded inputs, one JSON line per
shape gives, for the forward and for the backward: the device time and the
device ops per call (:func:`device_per_call`), the wrapper time (CUDA events
around one call, median of 30), the host ops with the most self time
(:func:`host_top`) and a float64 checksum of the outputs. The last line names
the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

SHAPES = [(512, 100, 20), (512, 100, 1), (65, 130, 5), (2048, 256, 32)]


def _device_ops(fn, calls):
    """(device us, device ops, {name: count}) that torch.profiler records over
    ``calls`` back-to-back calls of ``fn``: CUDA kernels, copies and fills."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, ops, names = 0.0, 0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us += e.self_device_time_total
            ops += e.count
            names[e.key] = e.count
    return us, ops, names


def host_top(fn, calls=20, k=8):
    """Where the host time of ``fn`` goes: the ``k`` host-side ops (torch ops
    and CUDA runtime calls) with the most self time in torch.profiler over
    ``calls`` back-to-back calls, per call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:k]
    return [{"name": e.key[:60], "self_us": e.self_cpu_time_total / calls, "count": e.count / calls} for e in top]


def device_per_call(fn, n=20, trials=5):
    """(device ms per call, device launches per call, {device op name: count})
    of ``fn``, after a warm-up call. Seen on the card: CUPTI now and then
    drops records, up to half of a 20-call window, or a whole window. So the
    launches per call are the most that ``trials`` profiles of one call each
    record, and the device time per call is the mean duration of the ops
    recorded over ``n`` back-to-back calls times the launches per call (with
    no record dropped, the sum over the n calls divided by n). Host time
    between the calls is not counted."""
    fn()
    torch.cuda.synchronize()
    per_call = max(_device_ops(fn, 1)[1] for _ in range(trials))
    for attempt in range(3):
        us, ops, names = _device_ops(fn, n)
        if ops > 0 and per_call > 0:
            if ops != per_call * n:
                print(f"device_per_call: the profiler kept {ops} of {per_call * n} device records")
            return us / ops * per_call / 1e3, per_call, names
        print(f"device_per_call: torch.profiler returned no device records (attempt {attempt + 1})")
    raise RuntimeError("torch.profiler recorded no device operation in 3 attempts: no device time")


def time_cuda_ms(fn, n=30, warm=3):
    """Median wall time of ``fn`` on the card by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose rgp_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)  # before the package is imported: the checkout's own
    from rgp_tpu_torch.kernels import RBF
    from rgp_tpu_torch.ops.cuda import psi2

    if not torch.cuda.is_available():
        raise SystemExit("psi2_times: no CUDA device; this runs on the card only")
    if not psi2.__file__.startswith(root):
        raise SystemExit(f"psi2_times: imported {psi2.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    for i, (T, M, Q) in enumerate(SHAPES):
        rng = np.random.default_rng(200 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        G = torch.as_tensor(rng.standard_normal((M, M)), dtype=torch.float32, device=dev)
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args = [x.to(torch.float32).contiguous().requires_grad_() for x in (*pre, Z)]

        def fwd():
            with torch.no_grad():
                return psi2.RBFPsi2Sum.apply(*args)

        out = psi2.RBFPsi2Sum.apply(*args)

        def bwd():
            return torch.autograd.grad(out, args, G, retain_graph=True)

        row = {"T": T, "M": M, "Q": Q}
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            ms, per_call, names = device_per_call(fn)
            res = fn()
            res = res if isinstance(res, tuple) else (res,)
            row[name] = {"device_ms": ms, "device_ops_per_call": per_call, "ops": names,
                         "wrapper_ms": time_cuda_ms(fn), "host_top": host_top(fn),
                         "checksum": [float(x.double().sum()) for x in res]}
        print(json.dumps(row))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "card": card}))


if __name__ == "__main__":
    main()
