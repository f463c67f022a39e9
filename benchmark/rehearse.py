"""Rehearse a cell's output check at many seeds in one process: the program
(a short window, then the check, as a run makes them), the lower-precision
control in the program's place, or the program with a fault planted.

    python3 -m benchmark.rehearse --workload rgp1-rollout-w16384 --mode program --seeds 1,2,3 [--seconds 2] [--out FILE]
    python3 -m benchmark.rehearse --workload rgp1-rollout-w16384 --mode control --seeds 1,2,3
    python3 -m benchmark.rehearse --workload rgp1-rollout-w16384 --mode fault:half_batch --seeds 1,2,3

The control is the plain reference run in float32 with TF32 matrix products
(the precision below the configuration's float32 with TF32 off), its rungs
taken by its own trial Cholesky factorizations, as a program takes them;
``--mode float32`` runs it without TF32, a witness of what float32 itself
gives beside the program. It
prints one JSON line a seed (numbers, limits, notes), then each number's
worst reading and the seeds that passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import check, drive, faults, inputs
from . import reference as ref
from .run import load_cell


def control_record(cfg, traffic, rec, seed, tf32=True):
    """What the reference in float32 gives where the window's calls would
    (``check_requests`` requests' rollouts), with TF32 products (the
    control) or without (a float32 witness beside the program)."""
    dt = torch.float32
    prec = ref.tf32_matmuls if tf32 else contextlib.nullcontext
    gen = inputs.generator(seed, rec.Y.device)
    params = inputs.served_params(cfg, rec, gen, dt)
    outs = []
    with prec():
        for _ in range(traffic["check_requests"]):
            Us = inputs.candidates(cfg, rec, traffic["width"], traffic["horizon"], gen)
            (_, m, v), = ref.rollout_branches(cfg, params, rec.Y, rec.U, Us, ref.Ladder(None))
            outs.append((Us, m, v))
    return {"outs": outs}, params


def rehearse(cell, seed, mode, seconds, device):
    cfg, traffic = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    rec = inputs.record(cfg, dtype, device, T=cfg.get("T"))
    if mode in ("control", "float32"):
        record, params = control_record(cfg, traffic, rec, seed, tf32=mode == "control")
        failed = 0
    else:
        setup, window = drive.DRIVERS[traffic["kind"]]
        plant = faults.plant(mode.split(":", 1)[1]) if mode.startswith("fault:") else None
        if plant is not None:
            plant.__enter__()
        try:
            state = setup(cfg, traffic, rec, seed, dtype)
            win = window(state, cfg, traffic, seconds, False)
        finally:
            if plant is not None:
                plant.__exit__(None, None, None)
        record, params, failed = win.record, state.params, win.failed
    numbers, notes = check.CHECKS[traffic["kind"]](cfg, traffic, cell.limits, record, params, rec, seed)
    lim = cell.limits["limits"]
    correct = all(v <= lim[k] for k, v in numbers.items()) and failed == 0
    return {"seed": seed, "mode": mode, "correct": correct, "failed": failed, "numbers": numbers, "notes": notes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rehearse: needs a CUDA device")
    cell = load_cell(args.workload)
    sink = open(args.out, "a") if args.out else sys.stdout
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = rehearse(cell, s, args.mode, args.seconds, torch.device("cuda", 0))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        sink.write(json.dumps(row) + "\n")
        sink.flush()
    if args.out:
        sink.close()
    lim = cell.limits["limits"]
    for k in lim:
        vals = [r["numbers"][k] for r in rows]
        print(f"{args.mode} {k}: worst {max(vals)!r} (seed {rows[vals.index(max(vals))]['seed']}), "
              f"limit {lim[k]!r}, over it {sum(v > lim[k] for v in vals)} of {len(vals)}")
    print(f"{args.mode}: correct on {sum(r['correct'] for r in rows)} of {len(rows)} seeds")


if __name__ == "__main__":
    main()
