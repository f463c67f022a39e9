#!/usr/bin/env python3
"""Where a rollout cell's traced requests spend their device operations,
device time, idle time and host waits, by the program's spans.

Runs the cell's window as ``python3 -m benchmark.run --trace 1`` does (the
output check left out), reads the traced stretch with ``benchmark/trace.py``
and ``benchmark/spans.py``, and prints one JSON line: the benchmark's
traced per-layer metrics; the device operations by where they were
launched (in an ``rgp.freerun.step``, in ``rgp.posteriors``, elsewhere in a
``bench.request``, outside any request, or with no launch in the trace),
which sum to the trace's count; device time and idle time by the same
places; the host waits on the device by name and place; the device time of
the ``psi.*`` spans by kernel name; the operators that wait on the device
inside ``rgp.posteriors``; and the traced requests' latency (each
``bench.request`` span's start to the end of the last device operation it
launched) beside the window's. Needs a CUDA device.

    python3 tools/span_attribution.py --workload rgp2mlp-rollout-w1024 --seed 7 [--seconds 5]
"""

import argparse
import json
import os
import statistics
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

METRICS = ("step_launches.rollout", "posteriors_ms.rollout", "posterior_syncs.rollout",
           "psi_device_ms_per_step.rollout", "step_idle_share.rollout", "launches_per_step.rollout",
           "idle_share.rollout", "graph_step_share.rollout")


def _top(d, n=8):
    """The ``n`` largest of ``d``, each name cut to 100 characters."""
    return [[k[:100], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def attribute(ctx):
    """The attribution record of a traced window's ``ctx``."""
    from benchmark import spans

    r, tr = spans.of(ctx), ctx.trace
    count, dev_ns = dict.fromkeys(spans.PLACES, 0), dict.fromkeys(spans.PLACES, 0)
    names_by = {p: {} for p in spans.PLACES}
    psi_by_name, in_psi = {}, {"step": 0, "posteriors": 0}
    for name, _, d, t in r.ops:
        p = spans.place(r, t)
        count[p] += 1
        dev_ns[p] += d
        names_by[p][name] = names_by[p].get(name, 0) + 1
        if any(n.startswith(spans.PSI) for n in r.holding(t)):
            psi_by_name[name] = psi_by_name.get(name, 0) + d
            if p in in_psi:
                in_psi[p] += d
    steps, posts = r.nesting.named(spans.STEP), r.nesting.named(spans.POSTERIORS)
    reqs = r.nesting.named(spans.REQUEST)
    idle = sum(e - s for s, e in r.gaps)
    idle_step, idle_post = spans.overlap_ns(r.gaps, steps), spans.overlap_ns(r.gaps, posts)
    idle_req = spans.overlap_ns(r.gaps, reqs) - idle_step - idle_post
    waits = {}
    for name, s, e in r.waits:
        key = f"{spans.place(r, s)}:{name}"
        n_, ns_ = waits.get(key, (0, 0))
        waits[key] = (n_ + 1, ns_ + e - s)
    ends = []
    for lo, hi in reqs:
        last = max((s + d for _, s, d, t in r.ops if t is not None and lo <= t <= hi), default=hi)
        ends.append((max(last, hi) - lo) / 1e6)
    ms = 1e-6
    return {
        "device_ops": len(tr.ops), "attributed": count, "sum_equals_ops": sum(count.values()) == len(tr.ops),
        "step_spans": len(steps), "units": ctx.units, "posteriors_spans": len(posts), "requests": len(reqs),
        "device_ms": {p: v * ms for p, v in dev_ns.items()},
        "psi_device_ms": {p: v * ms for p, v in in_psi.items()},
        "psi_device_ms_by_kernel": [[k, v * ms] for k, v in _top(psi_by_name, 10)],
        "psi_device_ms_total": sum(psi_by_name.values()) * ms, "busy_ms": tr.busy_s * 1e3,
        "idle_ms": {"total_gaps": idle * ms, "step": idle_step * ms, "posteriors": idle_post * ms,
                    "request_other": idle_req * ms, "outside": (idle - idle_step - idle_post - idle_req) * ms,
                    "edges": (tr.window_s - tr.busy_s) * 1e3 - idle * ms},
        "waits": {k: {"count": n, "ms": v * ms} for k, (n, v) in sorted(waits.items())},
        "top_ops_request_other": _top(names_by["request"]), "top_ops_outside": _top(names_by["outside"]),
        "step_span_ms_mean": statistics.fmean([(e - s) * ms for s, e in steps]) if steps else None,
        "traced_request_ms_median": statistics.median(ends) if ends else None,
        "window_request_ms_median": 1e3 * statistics.median(ctx.window.latencies) if ctx.window.latencies else None,
    }


def posterior_wait_ops(prof, r):
    """For each host wait inside ``rgp.posteriors``: the outermost and the
    innermost operator (``aten::...``) around it, counted by name."""
    import torch

    from benchmark import spans

    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() != cuda and not e.is_user_annotation() and e.name().startswith("aten::")]
    nest, out = spans.Nesting(ops), {}
    for _, s, _ in r.waits:
        if spans.POSTERIORS in r.holding(s):
            around = nest.around(s)
            key = f"{around[-1][0]} > {around[0][0]}" if around else "(no operator)"
            out[key] = out.get(key, 0) + 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import drive, inputs, run, spans, trace, yardstick

    if not torch.cuda.is_available():
        raise SystemExit("span_attribution: no CUDA device")
    dev = torch.device("cuda", 0)
    cell = run.load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    torch.cuda.set_device(dev)
    dtype = getattr(torch, cfg["dtype"])
    rec = inputs.record(cfg, dtype, dev, T=cfg.get("T"))
    setup, window = drive.DRIVERS[traffic["kind"]]
    state = setup(cfg, traffic, rec, args.seed, dtype)
    win = window(state, cfg, traffic, args.seconds, True)
    ctx = SimpleNamespace(kind=traffic["kind"], window=win, setup_s=0.0, trace=trace.read(win.trace),
                          units=win.trace_units, fp32_ops_per_s=yardstick.FP32_OPS_PER_S,
                          per_unit_ops=yardstick.rollout_per_step(cfg, traffic, rec.Y.shape[0]))
    out = {"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(dev),
           "torch": torch.__version__, "requests": win.steps,
           "metrics": {m: run.load_reader(m, cell.here)(ctx) for m in METRICS}}
    out.update(attribute(ctx))
    out["posterior_wait_ops"] = posterior_wait_ops(win.trace.prof, spans.of(ctx))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
