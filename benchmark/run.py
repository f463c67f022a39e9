"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; its
configuration, traffic mix, limits and metrics are files found by name:
``benchmark/configs/<config>.json`` (as ``BENCHMARK.json`` gives it),
``benchmark/traffic/<traffic>.json``, ``benchmark/limits/<workload>.json``,
``benchmark/metrics/<metric>.py``, each reader a ``read(ctx)`` that
returns a number or None, and ``benchmark/kernels/<kernel>.py`` for the
configuration's ``kernel`` and ``out_kernel`` (``reference.kernel_file``).
The traffic file's ``kind`` picks the driver (``drive.py``) and the check
(``check.py``).

The run needs as many CUDA devices as the cell asks for. It drives
``rgp_tpu_torch`` on the card, measures for ``--seconds`` seconds (with
``--trace 1`` then a stretch of requests under torch.profiler), compares the
window's outputs with the plain reference, and prints one JSON line last on
standard output; each compared number beside its limit goes last on
standard error and last in that line. A run that finds ``jax``, ``jaxlib``,
``flax`` or ``rgp_tpu`` among the loaded modules' top-level names exits
with an error and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "rgp_tpu")
ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def forbidden_modules(names):
    """The module names whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN`, compared whole (``rgp_tpu_torch`` is not
    ``rgp_tpu``)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_age_s():
    """Seconds since this process started (its start time in /proc against
    the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _json(path):
    return json.loads(Path(path).read_text())


def load_reader(name, here=HERE):
    path = Path(here) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell(SimpleNamespace):
    """One workload of ``BENCHMARK.json`` with its files read."""


def load_cell(name, root=ROOT):
    """The workload ``name`` of ``root``'s BENCHMARK.json, its configuration,
    traffic, limits and metrics read from the files they name; a kernel the
    configuration names that has no file fails here."""
    from .reference import layer_kernels

    root = Path(root)
    here = root / HERE.name
    spec = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _json(root / conf["file"])
    layer_kernels(config, here / "kernels")

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"), here=here,
                end_to_end=[m for m in spec["end_to_end"] if listed(m)],
                per_layer=[m for m in spec["per_layer"] if listed(m)])


def run_cell(cell, seed, seconds, trace, device, t_setup=None):
    """Set up, measure and check one run of ``cell`` on ``device``. Returns
    (result dict, checks {name: (value, limit)})."""
    import torch

    from . import check, drive, inputs, yardstick
    from . import trace as tracing

    cfg, traffic = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    rec = inputs.record(cfg, dtype, device, T=cfg.get("T"))
    setup, window = drive.DRIVERS[traffic["kind"]]
    state = setup(cfg, traffic, rec, seed, dtype)
    setup_s = process_age_s() if t_setup is None else time.perf_counter() - t_setup
    win = window(state, cfg, traffic, seconds, bool(trace))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    tr = tracing.read(win.trace) if win.trace is not None else None
    ctx = SimpleNamespace(kind=traffic["kind"], window=win, setup_s=setup_s, trace=tr, units=win.trace_units,
                          per_unit_ops=yardstick.rollout_per_step(cfg, traffic, rec.Y.shape[0]),
                          fp32_ops_per_s=yardstick.FP32_OPS_PER_S)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"], cell.here)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    params = state.params
    del state
    record = win.record
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, notes = check.CHECKS[traffic["kind"]](cfg, traffic, cell.limits, record, params, rec, seed)
    lim = cell.limits["limits"]
    checks = {k: (v, lim[k]) for k, v in numbers.items()}
    correct = all(v <= l for v, l in checks.values()) and win.failed == 0
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    result = {"correct": bool(correct),
              "attempted": win.steps,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops, "idle_gaps": tr.idle_gaps}
    result["notes"] = {"window_s": win.seconds, "steps": win.steps, "check": notes}
    result["checks"] = {k: {"value": v, "limit": l} for k, (v, l) in checks.items()}
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: forbidden modules loaded at start: {found}", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for k, (v, l) in checks.items():
        print(f"check {k} {v!r} limit {l!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
