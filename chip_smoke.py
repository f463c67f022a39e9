#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rgp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Require a CUDA device; print the card's name and power limit
   (``nvidia-smi``) and the TF32 flags, which must both be off.
2. Build K1 and K2, the hand-written CUDA Psi2 time-sum kernel and its
   backward, from ``rgp_tpu_torch/csrc/psi2_{fwd,bwd}.cu`` (nvcc, sm_90a, both
   at once).
3. Hold K1 and K2 against their plain PyTorch versions, run in float64 on the
   card from the same float32 inputs, at the config-1 layer shapes (T, M, Q) =
   (512, 100, 20) and (512, 100, 1), a shape that does not align to tiles
   (65, 130, 5) and a production shape (2048, 256, 32). Tolerance per element:
   K1 |k - p| <= 2e-4 |p| + 2e-5 max|p|; K2, all four outputs with a random
   cotangent, 3e-4 |p| + 3e-5 max|p|. Time each kernel and its plain float32
   version (CUDA events, warm, median of 30) and compute each bound. Then the
   autograd Function's gradients for (p, Z, mu, s) (K1 + K2, float32) against
   autograd of the plain chunked path (float64) at the config-1 layer shapes,
   at K2's tolerance.
4. Serve config 1 in float32 on the card: actuator data,
   ``deep_rgp_config(wins=[0,10], u_win=10, num_inducing=100)``,
   ``init_params(seed=0)``, then ``elbo`` (forward), ``compute_whitenings``,
   ``predict_train`` and ``freerun`` over the 512-step test horizon. The launch
   counts are set to 0 just before and read just after: K1 must rise by 2 per
   pass over the layers, K2 must not run and the plain Psi2 path must not be
   taken. Outputs must be finite; time freerun and predict_train, and profile
   one call of each (device busy share, device ops per step). Then the repo's
   f32-lane gates at its tests' sizes (T=128): float32 through K1 against
   float64 through the plain path from the same parameters, ELBO
   |e32-e64|/(1+|e64|) < 1e-3 at M=32 and a 64-step freerun trajectory
   rms/scale < 5e-2 at M=16.
5. Train config 1 in float32 on the card (``rgp_tpu_torch.bench.config1``):
   Adam on -elbo, cosine decay to 1%, whitening refresh every 100 steps, 1000
   steps timed after a 20-step warm-up. Counted over the timed call: K2 runs
   2 per step, K1 at least 2 per step, the plain Psi2 path never. Every loss
   is finite and the last ELBO is above the first. Print iterations/s, ms per
   step and the trained freerun RMSE beside the zero predictor's, and profile
   training steps. Then the f32-lane gate after training
   (tests/test_f32_lane.py): config-2 shape (drives, wins=[0,2,2], T=64...128,
   M=16), 20 float32 Adam steps through K1/K2, then |e32-e64|/(1+|e64|) < 1e-3.
6. float64 on the card (plain path): the golden-setup ELBO (actuator, M=50,
   seed 0, block=None) must equal -5946.347076392082 at rtol 1e-8, and 50
   Adam(1e-2) steps must pass the golden trajectory at steps 0, 9 and 24 at
   rtol 1e-6 (step 49 is printed only: the reference trajectory crosses a
   ladder rung there, ROADMAP.md Queue 3).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

_GOLDEN_E0 = -5946.347076392082  # tests/test_golden_regression.py
_GOLDEN_TRAJ = {0: -5946.347076393514, 9: -3795.857900524881, 24: -2375.0372891290613,
                49: -1293.6259234232734}
_TRAIN_STEPS = 1000
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
    and copy time from torch.profiler, user annotations left out) against the
    host wall time of the call, and the kernels launched. Profiling slows the
    host side, so the busy share here is a lower bound on the unprofiled
    one."""
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
        # a user annotation (e.g. "Optimizer.step#Adam.step") spans kernels
        # that are counted on their own: counting it too would count them twice
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
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


def k2_bound_ms(T, M, Q):
    """Least time for K2's work: (4Q+8) FP32 operations plus one exp per
    (t, m, n) element at the FP32 peak, against the inputs (base, E, D1, w, Z,
    Gs) read once and the outputs (dbase, dE, dw, dzC) written once."""
    ops = T * M * M * (4 * Q + 8 + 1)
    nbytes = 4 * (2 * T + 2 * T * M + 2 * M * M + 2 * T * Q + 2 * M * Q)
    t_ops, t_bytes = ops / _FP32_OPS_PER_S, nbytes / _HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _within(k, p, rel=3e-4, rel_max=3e-5):
    """(ok, max_abs_err, worst err/tol) for |k - p| <= rel |p| + rel_max max|p|."""
    err = (k.double() - p).abs()
    tol = rel * p.abs() + rel_max * p.abs().max()
    ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
    return ok, float(err.max()), float((err / tol.clamp(min=1e-300)).max())


def phase_k2(psi2):
    """Phase 3b: K2 against its plain version at K1's shapes, all four
    outputs, with a random cotangent; returns per-shape results."""
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES):
        rng = np.random.default_rng(200 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        G = torch.as_tensor(rng.standard_normal((M, M)), device=dev)
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args32 = [x.to(torch.float32).contiguous() for x in (*pre, Z, G + G.T)]
        args64 = [x.to(torch.float64) for x in args32]

        k = psi2.psi2_time_sum_bwd(*args32)
        torch.cuda.synchronize()
        ref = psi2.psi2_time_sum_bwd_plain(*args64)
        per = {}
        for name, a, b in zip(("dbase", "dE", "dw", "dzC"), k, ref):
            ok, err, worst = _within(a, b)
            per[name] = {"ok": ok, "max_abs_err": err, "max_rel_err": err / float(b.abs().max()),
                         "worst_err_over_tol": worst}
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd_plain(*args32))
        bound_ms, bound_by = k2_bound_ms(T, M, Q)
        row = {
            "T": T, "M": M, "Q": Q, "outputs": per,
            "max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "max_rel_err": max(v["max_rel_err"] for v in per.values()),
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k2", json.dumps(row))
        check(all(v["ok"] for v in per.values()),
              f"K2 disagrees with its plain version at (T,M,Q)={T, M, Q}: {per}")
        rows.append(row)
    return rows


def phase_vjp(psi2, psi_stats):
    """Phase 3c: gradients of sum(Psi2 * G) for (p, Z, mu, s) through the
    autograd Function (K1 + K2, float32) against autograd of the plain chunked
    path in float64, at the config-1 layer shapes."""
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    for i, (T, M, Q) in enumerate(_K1_SHAPES[:2]):
        rng = np.random.default_rng(300 + i)
        mu = rng.standard_normal((T, Q))
        s = rng.uniform(0.05, 0.4, (T, Q))
        Z = rng.standard_normal((M, Q))
        G = rng.standard_normal((M, M))
        p64 = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        grads = {}
        for dtype in (torch.float32, torch.float64):
            p = {k: v.to(dtype).requires_grad_() for k, v in p64.items()}
            x = [torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_() for a in (Z, mu, s)]
            if dtype == torch.float32:
                out = psi2.rbf_psi2_sum(p, *x)
            else:
                out = psi_stats._rbf_psi2_sum_chunked(p, *x, 128)
            (out * torch.as_tensor(G, dtype=dtype, device=dev)).sum().backward()
            grads[dtype] = {"log_var": p["log_var"].grad, "log_ls": p["log_ls"].grad,
                            "Z": x[0].grad, "mu": x[1].grad, "s": x[2].grad}
        per = {}
        for name, a in grads[torch.float32].items():
            ok, err, worst = _within(a, grads[torch.float64][name])
            per[name] = {"ok": ok, "max_abs_err": err, "worst_err_over_tol": worst}
        print("vjp", json.dumps({"T": T, "M": M, "Q": Q, "grads": per}))
        check(all(v["ok"] for v in per.values()),
              f"the Function's VJP disagrees with autograd of the plain path at {T, M, Q}: {per}")


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
    psi2.bwd_launches = 0
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
    print("serving launches", json.dumps({"k1": launches, "k2": psi2.bwd_launches, "per_stage": stage,
                                          "plain_psi2_calls": plain}))
    check(psi2.bwd_launches == 0, f"serving launched K2 {psi2.bwd_launches} times")
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


def phase_training(psi2, psi_stats):
    """Phase 5: config-1 training in float32 on the card, through the port's
    benchmark entry points. Returns the launch counts of the timed call."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.bench import config1
    from rgp_tpu_torch.models import rgp

    cfg, params, Y, U, Ut, sy, d = config1.setup(torch.float32)
    n_layers = cfg.n_hidden + 1
    config1.fit(cfg, params, Y, U, 20, 1e-2)  # warm-up: allocator, cuSOLVER, autograd
    torch.cuda.synchronize()

    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    p_fit, losses, ips = config1.timed_fit(cfg, params, Y, U, _TRAIN_STEPS, 1e-2, warmup=0)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    refreshes = -(-_TRAIN_STEPS // config1.WHITEN_EVERY)
    print("training launches", json.dumps({**counts, "steps": _TRAIN_STEPS, "whitening_refreshes": refreshes}))
    check(counts["k2"] == n_layers * _TRAIN_STEPS,
          f"K2 launched {counts['k2']} times in {_TRAIN_STEPS} steps, want {n_layers} per step")
    check(counts["k1"] >= n_layers * _TRAIN_STEPS,
          f"K1 launched {counts['k1']} times in {_TRAIN_STEPS} steps, want >= {n_layers} per step")
    check(counts["plain_psi2_calls"] == 0, f"training took the plain Psi2 path {counts['plain_psi2_calls']} times")

    elbos = (-losses.double()).cpu().numpy()
    check(losses.shape == (_TRAIN_STEPS,) and bool(np.isfinite(elbos).all()), "a training loss is not finite")
    check(elbos[-1] > elbos[0], f"training did not raise the ELBO: {elbos[0]} -> {elbos[-1]}")
    with torch.no_grad():
        fm, fv = rgp.freerun(cfg, p_fit, Y, U, Ut)
    check(bool(torch.isfinite(fm).all() and (fv > 0).all()), "trained freerun not finite")
    pred = sy.inverse(fm.double().cpu().numpy())
    result = {
        "config": "rgp1L_actuator_M100 float32, cosine decay 1e-2 -> 1e-4, whitening every 100",
        "steps": _TRAIN_STEPS, "iters_per_s": ips, "ms_per_step": 1e3 / ips,
        "elbo_first": float(elbos[0]), "elbo_last": float(elbos[-1]),
        "freerun_rmse_trained": float(np.sqrt(np.mean((pred - d.y_test) ** 2))),
        "zero_predictor_rmse": float(np.sqrt(np.mean(d.y_test ** 2))),
    }
    print("training", json.dumps(result))

    # steady steps with fixed bases (a refresh is 1 step in 100): host time of
    # the forward bound, of forward + backward, and of whole Adam steps, each
    # ending in a synchronize; then one profiled run of 10 steps
    with torch.no_grad():
        wh = rgp.compute_whitenings(cfg, params, Y, U, block=None)
    leaves = [x.detach().clone().requires_grad_() for _, x in train.leaves_with_paths(params)]
    p = train.with_leaves(params, leaves)

    def loss():
        return -rgp.elbo(cfg, p, Y, U, block=None, whitening=wh)

    steps = 10
    split = {
        "forward_ms": time_host_ms(loss, n=20),
        "forward_backward_ms": time_host_ms(lambda: torch.autograd.grad(loss(), leaves), n=20),
        "adam_step_ms": time_host_ms(lambda: train.fit_adam(
            lambda q: -rgp.elbo(cfg, q, Y, U, block=None, whitening=wh), params, iters=steps,
            learning_rate=1e-2), n=3) / steps,
        "whitening_refresh_ms": time_host_ms(lambda: rgp.compute_whitenings(cfg, p, Y, U, block=None), n=10),
    }
    print("training step split", json.dumps(split))
    profile_device(lambda: train.fit_adam(
        lambda q: -rgp.elbo(cfg, q, Y, U, block=None, whitening=wh), params, iters=steps,
        learning_rate=1e-2), "training steps", steps)
    return counts


def phase_f32_lane_trained(psi2):
    """Phase 5b: tests/test_f32_lane.py's after-training gate on the card:
    config-2 shape, 20 float32 Adam steps through K1/K2, then the trained
    parameters' float32 ELBO against float64 (plain path)."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    d = datasets.standardized_tensors(datasets.drives(T=128, seed=7), dtype=torch.float32)
    Y, U = d.Y, d.U
    cfg = rgp.deep_rgp_config(wins=[0, 2, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=16)
    p32 = rgp.init_params(cfg, Y, U, dtype=torch.float32)
    n0 = psi2.bwd_launches
    res = train.fit_adam(lambda p: -rgp.elbo(cfg, p, Y, U, block=None), p32, iters=20, learning_rate=1e-2)
    k2 = psi2.bwd_launches - n0
    with torch.no_grad():
        e32 = float(rgp.elbo(cfg, res.params, Y, U, block=None))
        e64 = float(rgp.elbo(cfg, _cast(res.params, torch.float64), Y.double(), U.double(), block=None))
    rel = abs(e32 - e64) / (1.0 + abs(e64))
    print("f32 lane after training", json.dumps({"elbo32": e32, "elbo64": e64, "rel": rel, "k2_launches": k2,
                                                  "last_loss": float(res.losses[-1])}))
    check(k2 > 0, "the f32 training lane did not go through K2")
    check(bool(torch.isfinite(res.losses).all()), "a float32 training loss is not finite")
    check(rel < 1e-3, f"trained f32 ELBO {e32} vs f64 {e64}: rel {rel} (gate 1e-3)")


def phase_golden():
    """Phase 6: the float64 golden ELBO and trajectory on the card."""
    from rgp_tpu_torch import train
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

    res = train.fit_adam(lambda p: rgp.neg_elbo(cfg, p, d64.Y, d64.U, block=None), params,
                         iters=50, learning_rate=1e-2)
    elbos = (-res.losses).cpu().numpy()
    traj = {i: {"elbo": float(elbos[i]), "golden": g, "rel": abs(elbos[i] - g) / abs(g)}
            for i, g in _GOLDEN_TRAJ.items()}
    print("golden f64 trajectory", json.dumps(traj))
    for i in (0, 9, 24):
        check(traj[i]["rel"] <= 1e-6, f"f64 golden trajectory step {i}: {traj[i]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rgp_tpu_torch")):
        fail(f"no rgp_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, root)

    # phase 1
    from rgp_tpu_torch.bench.config1 import card as query_card

    card = query_card()
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
    libs = psi2.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build (K1 and K2 at once): {build_s:.1f} s")
    for name, so in libs.items():
        print(f"  {name}: {os.path.relpath(so, root)}")
        log = so.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print("  ptxas:", line.strip())

    k1_rows = phase_k1(psi2)  # phase 3
    k2_rows = phase_k2(psi2)
    phase_vjp(psi2, psi_stats)
    serving = phase_serving(psi2, psi_stats)  # phase 4
    phase_f32_lane(psi2)
    training = phase_training(psi2, psi_stats)  # phase 5
    phase_f32_lane_trained(psi2)
    phase_golden()  # phase 6

    def row(name, src, replaces, tpu_kernel, launches, by_path, rows):
        main_row = rows[0]  # (512, 100, 20): config 1's hidden layer
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_kernel": tpu_kernel,
            "launches": launches, "launches_by_path": by_path,
            "shape": [main_row["T"], main_row["M"], main_row["Q"]],
            "max_abs_err": main_row["max_abs_err"], "max_rel_err": main_row["max_rel_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "shapes": rows, "card": card,
        }

    print(json.dumps({"kernels": [
        row("psi2_fwd", "rgp_tpu_torch/csrc/psi2_fwd.cu", "rgp_tpu/ops/pallas/psi2.py:147",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_kernel (_psi2_pallas_raw)", training["k1"],
            {"training": training["k1"], "serving": serving}, k1_rows),
        row("psi2_bwd", "rgp_tpu_torch/csrc/psi2_bwd.cu", "rgp_tpu/ops/pallas/psi2.py:274",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_bwd_kernel (_psi2_bwd_raw)", training["k2"],
            {"training": training["k2"], "serving": 0}, k2_rows),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
