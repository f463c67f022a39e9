#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rgp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Require a CUDA device; print the card's name and power limit
   (``nvidia-smi``) and the TF32 flags, which must both be off.
2. Build K1, the hand-written CUDA Psi2 time-sum kernel, from
   ``rgp_tpu_torch/csrc/psi2_fwd.cu`` (nvcc, sm_90a).
3. Hold K1 against its plain PyTorch version, run in float64 on the card from
   the same float32 inputs, at the config-1 layer shapes (T, M, Q) =
   (512, 100, 20) and (512, 100, 1), a shape that does not align to tiles
   (65, 130, 5) and a production shape (2048, 256, 32). Tolerance per element:
   |k - p| <= 2e-4 |p| + 2e-5 max|p|. Time K1 and the plain float32 version
   (CUDA events, warm, median of 30) and compute K1's bound.
4. Serve config 1 in float32 on the card: actuator data,
   ``deep_rgp_config(wins=[0,10], u_win=10, num_inducing=100)``,
   ``init_params(seed=0)``, then ``elbo`` (forward), ``compute_whitenings``,
   ``predict_train`` and ``freerun`` over the 512-step test horizon. K1's
   launch count is set to 0 just before and read just after: it must rise by
   2 per pass over the layers and the plain Psi2 path must not be taken.
   Outputs must be finite; time freerun and predict_train, and profile one
   call of each (device busy share, device ops per step). Then the repo's
   f32-lane gates at its tests' sizes (T=128): float32 through K1 against
   float64 through the plain path from the same parameters, ELBO
   |e32-e64|/(1+|e64|) < 1e-3 at M=32 and a 64-step freerun trajectory
   rms/scale < 5e-2 at M=16.
5. float64 on the card (plain path): the golden-setup ELBO (actuator, M=50,
   seed 0, block=None) must equal -5946.347076392082 at rtol 1e-8.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_GOLDEN_E0 = -5946.347076392082  # tests/test_golden_regression.py
_FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores
_HBM_BYTES_PER_S = 3.35e12  # H100 SXM
_K1_SHAPES = [(512, 100, 20), (512, 100, 1), (65, 130, 5), (2048, 256, 32)]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


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


def time_host_ms(fn, n):
    """Median host time of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_device(fn, label, steps):
    """One profiled call of ``fn``: device busy time (the sum of CUDA kernel
    and copy time from torch.profiler) against the host wall time of the
    call, and the kernels launched. Profiling slows the host side, so the
    busy share here is a lower bound on the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n_kernels, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.self_device_time_total
            n_kernels += e.count
            top.append((e.self_device_time_total, e.count, e.key[:60]))
    top.sort(reverse=True)
    row = {
        "what": label, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else "not measured",
        "device_ops": n_kernels, "device_ops_per_step": n_kernels / steps,
        "top_by_device_time": [{"us": t, "count": c, "name": k} for t, c, k in top[:6]],
    }
    print("profile", json.dumps(row))
    return row


def k1_bound_ms(T, M, Q):
    """Least time for K1's work: (2Q+6) FP32 operations plus one exp (counted
    as one operation) per (t, m, n) element at the FP32 peak, against each
    input read once and the output written once at the memory rate."""
    ops = T * M * M * (2 * Q + 6 + 1)
    nbytes = 4 * (T + T * M + M * M + T * Q + M * Q + M * M)
    t_ops, t_bytes = ops / _FP32_OPS_PER_S, nbytes / _HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k1(psi2):
    """Phase 3: K1 against its plain version; returns per-shape results."""
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES):
        rng = np.random.default_rng(100 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        # lengthscale sqrt(Q) keeps Psi2 entries O(1) at every width
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args32 = [x.to(torch.float32).contiguous() for x in (*pre, Z)]
        args64 = [x.to(torch.float64) for x in args32]

        k = psi2.psi2_time_sum(*args32)
        torch.cuda.synchronize()
        ref = psi2.psi2_time_sum_plain(*args64)
        err = (k.double() - ref).abs()
        pmax = ref.abs().max()
        tol = 2e-4 * ref.abs() + 2e-5 * pmax
        ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_plain(*args32))
        bound_ms, bound_by = k1_bound_ms(T, M, Q)
        row = {
            "T": T, "M": M, "Q": Q,
            "max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / pmax),
            "worst_err_over_tol": float((err / tol).max()),
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k1", json.dumps(row))
        check(ok, f"K1 disagrees with its plain version at (T,M,Q)={T, M, Q}: {row}")
        rows.append(row)
    return rows


def phase_serving(psi2, psi_stats):
    """Phase 4: config 1 in float32 on the card through the port's entry points."""
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    data = datasets.actuator()
    d32 = datasets.standardized_tensors(data, dtype=torch.float32)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    params = rgp.init_params(cfg, d32.Y, d32.U, seed=0)
    Y, U, Ut = d32.Y, d32.U, d32.U_test
    n_layers = cfg.n_hidden + 1
    check(Y.is_cuda and params["out"]["Z"].is_cuda, "entry points did not build on the card")

    psi2.launches = 0
    psi_stats.plain_psi2_calls = 0
    stage = {}
    with torch.no_grad():
        e32 = rgp.elbo(cfg, params, Y, U, block=None)
        torch.cuda.synchronize()
        stage["elbo"] = psi2.launches
        wh = rgp.compute_whitenings(cfg, params, Y, U, block=None)
        torch.cuda.synchronize()
        stage["compute_whitenings"] = psi2.launches - sum(stage.values())
        pm, pv = rgp.predict_train(cfg, params, Y, U)
        torch.cuda.synchronize()
        stage["predict_train"] = psi2.launches - sum(stage.values())
        fm, fv = rgp.freerun(cfg, params, Y, U, Ut)
        torch.cuda.synchronize()
        stage["freerun"] = psi2.launches - sum(stage.values())
    launches, plain = psi2.launches, psi_stats.plain_psi2_calls
    print("serving launches", json.dumps({"k1": launches, "per_stage": stage, "plain_psi2_calls": plain}))
    for name, n in stage.items():
        check(n >= n_layers, f"{name}: K1 launched {n} times, want >= {n_layers} (one per layer)")
    check(plain == 0, f"psi_statistics took the plain Psi2 path {plain} times on float32 CUDA")

    check(e32.shape == () and bool(torch.isfinite(e32)), f"elbo not a finite scalar: {e32}")
    check(len(wh) == n_layers and all(bool(torch.isfinite(w.W).all()) for w in wh),
          "compute_whitenings: non-finite basis")
    T, T_star = Y.shape[0], Ut.shape[0]
    for name, (m, v), n in (("predict_train", (pm, pv), T), ("freerun", (fm, fv), T_star)):
        check(m.shape == (n, 1) and v.shape == (n, 1), f"{name}: shapes {m.shape}, {v.shape}")
        check(bool(torch.isfinite(m).all() and torch.isfinite(v).all() and (v > 0).all()),
              f"{name}: non-finite mean or non-positive variance")

    # the same parameters in float64 (plain path), for the record: at this
    # untrained init point the float32 bound is far from float64 in the JAX
    # reference too, so no gate applies here (the f32-lane gates run below at
    # the sizes the repo's own tests use)
    with torch.no_grad():
        e64 = float(rgp.elbo(cfg, _cast(params, torch.float64), Y.double(), U.double(), block=None))
    print("full-size f32 vs f64 elbo", json.dumps({"elbo32": float(e32), "elbo64": e64}))

    y_test = data.y_test[:, 0]
    pred = d32.sy.inverse(fm.double().cpu().numpy())[:, 0]
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    zero_rmse = float(np.sqrt(np.mean(y_test ** 2)))

    with torch.no_grad():
        freerun_ms = time_host_ms(lambda: rgp.freerun(cfg, params, Y, U, Ut), n=3)
        predict_ms = time_host_ms(lambda: rgp.predict_train(cfg, params, Y, U), n=10)
        profile_device(lambda: rgp.freerun(cfg, params, Y, U, Ut), "freerun", int(T_star))
        profile_device(lambda: rgp.predict_train(cfg, params, Y, U), "predict_train", 1)
    serving = {
        "config": "rgp1L_actuator_M100 float32 (init point, untrained)",
        "freerun_rmse": rmse, "zero_predictor_rmse": zero_rmse,
        "freerun_horizon_steps": int(T_star), "freerun_latency_ms": freerun_ms,
        "freerun_steps_per_s": T_star / (freerun_ms / 1e3),
        "predict_train_latency_ms": predict_ms,
    }
    print("serving", json.dumps(serving))
    return launches


def phase_f32_lane(psi2):
    """Phase 4b: the repo's f32-lane gates (tests/test_f32_lane.py) on the
    card: float32 through K1 against float64 through the plain path, from the
    same float32 parameters, at the tests' sizes."""
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.data.windows import Standardizer
    from rgp_tpu_torch.models import rgp

    d = datasets.actuator()
    T = 128
    dev = torch.device("cuda")

    def std(a):
        return torch.as_tensor(Standardizer.fit(a).transform(a), dtype=torch.float32, device=dev)

    Y, U = std(d.y_train[:T]), std(d.u_train[:T])
    su = Standardizer.fit(d.u_train[:T])
    Ut = torch.as_tensor(su.transform(d.u_test[:64]), dtype=torch.float32, device=dev)
    n0 = psi2.launches
    with torch.no_grad():
        cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=32)
        p32 = rgp.init_params(cfg, Y, U, seed=0)
        e32 = float(rgp.elbo(cfg, p32, Y, U, block=None))
        e64 = float(rgp.elbo(cfg, _cast(p32, torch.float64), Y.double(), U.double(), block=None))
        cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=16)
        p32 = rgp.init_params(cfg, Y, U, seed=0)
        m32, v32 = rgp.freerun(cfg, p32, Y, U, Ut)
        m64, _ = rgp.freerun(cfg, _cast(p32, torch.float64), Y.double(), U.double(), Ut.double())
    rel = abs(e32 - e64) / (1.0 + abs(e64))
    traj = float(((m32.double() - m64) ** 2).mean().sqrt() / ((m64 ** 2).mean().sqrt() + 1e-9))
    print("f32 lane", json.dumps({"elbo32": e32, "elbo64": e64, "rel": rel,
                                  "freerun_rms_over_scale": traj, "k1_launches": psi2.launches - n0}))
    check(psi2.launches - n0 >= 4, "f32 lane did not go through K1")
    check(rel < 1e-3, f"f32 ELBO {e32} vs f64 {e64}: rel {rel} (gate 1e-3)")
    check(bool(torch.isfinite(m32).all() and (v32 > 0).all()), "f32 freerun not finite")
    check(traj < 5e-2, f"f32 freerun off f64 by rms/scale {traj} (gate 5e-2)")


def phase_golden():
    """Phase 5: the float64 golden ELBO on the card."""
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    d64 = datasets.standardized_tensors(datasets.actuator(), dtype=torch.float64)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    params = rgp.init_params(cfg, d64.Y, d64.U, dtype=torch.float64, seed=0)
    with torch.no_grad():
        e0 = float(rgp.elbo(cfg, params, d64.Y, d64.U, block=None))
    rel = abs(e0 - _GOLDEN_E0) / abs(_GOLDEN_E0)
    print("golden f64", json.dumps({"elbo": e0, "golden": _GOLDEN_E0, "rel": rel}))
    check(rel <= 1e-8, f"f64 golden ELBO {e0} vs {_GOLDEN_E0}: rel {rel}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rgp_tpu_torch")):
        fail(f"no rgp_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, root)

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip()
    print(card)  # name and power limit, as nvidia-smi prints them
    from rgp_tpu_torch import linalg  # noqa: F401  (pins TF32 off at import)
    from rgp_tpu_torch.ops import psi_stats
    from rgp_tpu_torch.ops.cuda import psi2

    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    print("tf32", json.dumps(tf32))
    check(not any(tf32.values()), f"TF32 is on: {tf32}")
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    # phase 2
    t0 = time.perf_counter()
    so = psi2.build()
    build_s = time.perf_counter() - t0
    print(f"k1 build: {build_s:.1f} s -> {os.path.relpath(so, root)}")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    rows = phase_k1(psi2)  # phase 3
    launches = phase_serving(psi2, psi_stats)  # phase 4
    phase_f32_lane(psi2)
    phase_golden()  # phase 5

    main_row = rows[0]  # (512, 100, 20): config 1's hidden layer
    print(json.dumps({"kernels": [{
        "name": "psi2_fwd",
        "route": "cuda",
        "source": "rgp_tpu_torch/csrc/psi2_fwd.cu",
        "replaces": "rgp_tpu/ops/pallas/psi2.py:147",
        "tpu_kernel": "rgp_tpu/ops/pallas/psi2.py::_psi2_kernel (_psi2_pallas_raw)",
        "launches": launches,
        "launches_on_main_path": launches,
        "shape": [main_row["T"], main_row["M"], main_row["Q"]],
        "max_abs_err": main_row["max_abs_err"],
        "max_rel_err": main_row["max_rel_err"],
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the RBF Psi2 time sum",
        "shapes": rows,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
