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
   (65, 130, 5), a production shape (2048, 256, 32), the config-2 hidden
   layers (250, 100, 16) and (250, 100, 12) (Q padded to the compiled width
   20; config 2's output layer is (250, 100, 1)), and at shapes whose
   K2 columns do not fit in shared memory, (40, 600, 128) (both kernels) and
   (24, 1200, 20) (K2). Tolerance per element: K1 |k - p| <= 2e-4 |p| +
   2e-5 max|p|, and its output exactly symmetric; K2, all five outputs with a
   random cotangent, 3e-4 |p| + 3e-5 max|p|, and a transposed and an expanded
   cotangent giving the bits of their dense copies. Per kernel and shape:
   the wrapper time and the plain float32 version's (CUDA events, warm,
   median of 30), the device time and device launches per call
   (torch.profiler; each kernel must be one launch a call, alone), a rerun
   that must give the same bits, and the bound. Then the autograd Function's
   gradients for (p, Z, mu, s) (K1 + K2, float32) against autograd of the
   plain chunked path (float64) at the config-1 layer shapes, at K2's
   tolerance.
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
   Adam on -elbo, cosine decay to 1%, whitening refresh every 100 steps, 500
   steps (``bench.py`` runs 1000; cut to fit phase 10) timed after a 20-step
   warm-up. Counted over the timed call: K2 runs
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
7. Configs 2 and 3 in float32 through ``rgp_tpu_torch.bench.harness``, the
   entry point of ``python -m rgp_tpu_torch.bench``. Config 2: ``rgp2_mlp``
   on drives at full width (T=250 train, wins [0,6,6], u_win 10, M=100,
   back-constraint MLP (32,)), 300 Adam steps, 1 restart. Counted over the
   run: K2 exactly 3 launches per step (two hidden layers and the output), K1
   at least 3, the plain Psi2 path never. Every loss finite, the last ELBO
   above the first, the harness's freerun over the 250 test steps finite
   with positive variances (losses, means, variances, config and loss are
   the fit that ``run(return_fit=True)`` kept). Print it/s, ms per steady
   step, the freerun RMSE beside the zero predictor's and the degeneracy
   flags, and time and profile 10 more steps of that loss from the trained
   point (device busy share, device ops per step). Config 3: ``gp_narx``
   and ``gp_narx_matern`` on actuator at M=50, 300 steps each (``all.py``'s
   rows run 1000; cut to fit phase 10): every loss
   finite, the ELBO rises; print it/s, the first and last ELBO, the RMSE
   beside the zero predictor's and the flags; then time and profile 10
   steady ``gp_narx`` steps in the same way.
8. Config 4 in float32 through the harness on ``long_corpus`` at full width
   (T=16384: a NARX design of 12278 x 15, ``y_win`` 10, ``u_win`` 5, M=100,
   batch 512): the five routes at 300 steps each (``rgp_tpu/bench/all.py``'s
   quick budget runs ``gp_narx_collapsed`` and ``svgp_natgrad`` at 1000; cut
   to fit phase 10). Certain
   inputs: over the five runs K1 and K2 launch 0 times and the plain Psi2 path
   is never taken. Every route but the EMA one (recorded as diverging in
   BASELINE.md) must have finite losses, a last ELBO above the first and a
   finite freerun over the 4096 test steps; the freerun RMSE is printed, not
   gated (the SVGP scored through its q(u) is recorded as worse than the zero
   predictor). Per route: the harness record, ms a steady step and device ops
   and busy share a step (10 steps from the trained point through
   ``fit_adam`` or ``fit_minibatch``), and the wall time of a 4096-step
   freerun for ``svgp_natgrad`` and ``gp_narx_collapsed``. Then one
   ``svgp.elbo`` with uncertain inputs at (T, M, Q) = (512, 100, 20), forward
   and backward: exactly one K1 and one K2 launch; the Psi2 K1 gave inside it
   and the gradient of Z through K2 (at the cotangent the bound handed K2)
   against their plain float64 versions at K1's and K2's tolerances, and
   the ELBO against the float64 plain bound at 2e-4 relative.

9. Config 5 in float32 at the committed anchor ``artifacts/pcheck_params_r5.npz``
   (the flagship: actuator, ``deep_rgp_config(wins=[0,10], u_win=10,
   num_inducing=100)``, 25 hyperparameters).
   9a. The potential: the frozen-basis float64 potential at the anchor must
   equal ``U_f64_frozen`` of ``artifacts/surrogate_check_r5.json`` (-13.3)
   within its rounding (0.05). At the last draw of each of the first 128
   chains of ``artifacts/pcheck_tpu_r5.npz``, one batched float32
   value-and-gradient through ``make_rgp_potential``'s vmapped potential on
   each route, ``scan`` (the plain chunked Psi2, block 32) and ``auto`` (K1/K2
   through the Function's vmap rule: exactly one K1 and one K2 launch per
   chain per layer, the plain path never), against the float64 plain
   potential at the same points. float32 itself is up to ~1.6 nats off
   float64 at these points (the plain route, measured on the card; the
   surrogate check's 0.79 was the worst of four points), so each route is held
   against what float32 does: the plain route's median value error within 1
   nat, and each route's worst value error and worst gradient error at most
   twice the plain float32 route's own. Per route: ms per batched
   value-and-gradient, device ops and busy share, launches, peak memory.
   9b. The NUTS twin (``rgp_tpu_torch.bench.sampling.bench_nuts``) at
   half ``rgp_tpu/bench/all.py``'s quick budget (128 chains, 12 warmup steps,
   4 draws; the quick budget's 24 and 8 cut to fit phase 10) with the JAX
   protocol (``scan``): every draw finite, every group's
   final step size at least 1e-2 (a collapsed step size is the death-spiral
   signature), K2 never launched and K1 only by the frozen whitening's ladder
   pass at the anchor (one per layer). Printed, not gated: the twin's JSON
   line, and the
   draws' moment statistics against ``artifacts/pcheck_tpu_r5.npz`` (the same
   float32 frozen-basis surrogate) and, for information only, against the
   float64 fresh-basis chain ``artifacts/pcheck_cpu_r5.npz`` (another
   surrogate).
   9c. ``sample_nuts`` with 4 chains (``auto``, a fresh laddered whitening per
   evaluation, ``hessian_precondition=True``), 6 warmup steps and 4 draws:
   finite draws, and K1 and K2 launched on that path.
   9d. The SMC twin (``bench_smc``, 1024 particles over the 512 test steps of
   the flagship fitted for 300 steps): a finite log-marginal and every step's
   ESS above 0; steps/s, the log-marginal and the mean ESS fraction printed.
10. Tempered SMC and the examples, float32, on the same anchor.
   10a. One batched tempered log-likelihood (``sample.api.make_rgp_loglik``:
   ``rgp.elbo`` with the default jitter and a fresh laddered whitening) at 512
   particles drawn from ``sample_tempered``'s prior (std 3 about the
   anchor), on both routes: ``auto`` must launch K1 exactly once per particle
   per layer (1024) with no K2 and no plain path, ``scan`` (block 32) no K1.
   Per route: ms a call, device ops, busy share, peak memory. The routes are
   held against float64 (plain) at 16 particles and against each other at
   512 under phase 9a's rule, in relative gaps |x - e64| / (1 + |e64|) (the
   prior's draws reach ELBOs of -1e6): the plain route's median gap within
   the f32 lane's 1e-3, the kernel route's worst gap at most twice the plain
   route's, and the median auto-against-scan gap at most twice the plain
   route's median gap to float64. A particle whose two routes part by more,
   or are not both finite, is printed with each layer's ladder rung on each
   route.
   10b. ``sample_tempered`` at 512 particles with the reference's defaults
   (50 stages, ESS target 0.5, 3 moves, step scale 0.5): K1 exactly 1024 per
   log-likelihood evaluation, no K2, no plain path; log Z finite, the beta
   schedule increasing to ``beta_final`` (a truncation below 1 is printed,
   not failed), 0 < accept <= 1, every particle finite, and the ELBO at the
   particle mean no more than 50 nats below the anchor's. Printed: log Z,
   stages, accept, wall seconds, evaluations and particle-evaluations per
   second.
   10c. The five example scripts (``rgp_tpu_torch.examples``) in this
   process on the card at the cut sizes of ``_EXAMPLES``: each must print its
   JSON line; wall seconds and launch counts printed.

Each phase prints its wall seconds. The line before the last is ``{"kernels": [...]}``; the last line is
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
_TRAIN_STEPS = 500  # cut from bench.py's 1000 to fit phase 10 in the run's 1200 s
_FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores
_HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# config 1's layers, a ragged shape, a production shape, then config 2's
# hidden layers (Q 16 and 12 run at the compiled width 20; its output layer is
# (250, 100, 1))
_K1_SHAPES = [(512, 100, 20), (512, 100, 1), (65, 130, 5), (2048, 256, 32), (250, 100, 16), (250, 100, 12)]
_CONFIG2_STEPS = 300  # rgp_tpu/bench/all.py's quick sweep
_CONFIG3_STEPS = 300  # cut from rgp_tpu/bench/all.py's 1000 (config-3 rows) to fit phase 10
# shapes whose K2 columns do not fit in shared memory: the kernel streams them
_K2_STREAM_SHAPES = [(40, 600, 128), (24, 1200, 20)]
# config 4's routes and steps: all five at 300 (rgp_tpu/bench/all.py's quick
# budget runs the exact route and the named SVGP route at 1000; cut to fit
# phase 10)
_C4_ROUTES = {"gp_narx_collapsed": 300, "svgp_natgrad": 300, "svgp_natgrad_collapsed": 300,
              "gp_narx_minibatch": 300, "gp_narx_minibatch_ema": 300}
_C4_BATCH = 512  # rgp_tpu/bench/harness.py's default
_C4_TIMED_FREERUNS = ("gp_narx_collapsed", "svgp_natgrad")
_SVGP_UNCERTAIN = (512, 100, 20)  # (T, M, Q): config 1's hidden-layer shape
# config 5: the committed anchor and the JAX package's draws at it
_C5_ANCHOR = "artifacts/pcheck_params_r5.npz"
_C5_TPU_DRAWS = "artifacts/pcheck_tpu_r5.npz"  # (256 chains, 64 draws, 25): the f32 frozen-basis surrogate
_C5_CPU_DRAWS = "artifacts/pcheck_cpu_r5.npz"  # (4, 400, 25): the f64 fresh-basis chain, another surrogate
_C5_U_ANCHOR = -13.3  # U_f64_frozen at the anchor, artifacts/surrogate_check_r5.json (2 decimals)
_C5_CHAINS = 128
_C5_WARMUP, _C5_DRAWS = 12, 4  # half rgp_tpu/bench/all.py:35's quick budget (24, 8), to fit phase 10
_C5_SMC_PARTICLES = 1024  # rgp_tpu/bench/all.py:128
_C5_TEMPERED_PARTICLES = 512  # sample_tempered's default
_C5_PRIOR_STD = 3.0  # sample_tempered's default prior, centred on the anchor
# the five examples at cut sizes (their defaults train for thousands of steps)
_EXAMPLES = [
    ("actuator_rgp", ["--iters", "200"]),
    ("drives_deep_rgp", ["--iters", "200", "--back-cstr"]),
    ("minibatch_svgp", ["--iters", "200"]),
    ("nuts_smc_demo", ["--iters", "200", "--samples", "2", "--warmup", "4"]),
    ("evidence_tempered_smc", ["--iters", "200", "--particles", "256"]),
]


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


def time_host_ms(fn, n):
    """Median host time of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_one_launch(per_call, names, kernel, shape):
    """One device launch a call: the kernel is the only device op."""
    check(per_call == 1 and len(names) == 1 and kernel in next(iter(names)),
          f"{kernel} at (T,M,Q)={shape}: {per_call} device ops per call, {names}; want the kernel alone, once")


def bit_identical(a, b):
    """Two results of the same call on the same inputs are equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return all(bit_identical(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _card_events(prof):
    """{kernel or copy name: (device us, count)} of a torch.profiler trace,
    summed from its recorded events (``kineto_results``), user annotations
    left out (one spans kernels that are counted on their own)."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", bool)():
            us, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    return by_name


def profile_device(fn, label, steps):
    """One profiled call of ``fn``: device busy time (the sum of CUDA kernel
    and copy time from torch.profiler, user annotations left out) against the
    host wall time of the call, and the kernels launched. Only the card's
    activity is traced, and its events are summed as the profiler recorded
    them (:func:`_card_events`), without the per-event Python objects that
    ``key_averages()`` builds (minutes at 10^5 device ops a call).
    :func:`profile_readings` sets the two readings side by side. Profiling
    slows the host side, so the busy share here is a lower bound on the unprofiled
    one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = _card_events(prof)
    busy_us = sum(us for us, _ in by_name.values())
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(((us, c, k[:60]) for k, (us, c) in by_name.items()), reverse=True)
    row = {
        "what": label, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else "not measured",
        "device_ops": n_kernels, "device_ops_per_step": n_kernels / steps,
        "top_by_device_time": [{"us": t, "count": c, "name": k} for t, c, k in top[:6]],
    }
    print("profile", json.dumps(row))
    return row


def profile_readings(fn, label):
    """The device ops and busy time of one call of ``fn`` read three ways:
    ``key_averages()`` of a trace of host and card, :func:`_card_events` of
    that same trace, and :func:`profile_device` (a trace of the card alone).
    Printed side by side, so that device op counts read the first way and
    the last can be compared."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, busy_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ops += e.count
            busy_us += e.self_device_time_total
    events = _card_events(prof).values()
    card_only = profile_device(fn, label, 1)
    row = {"what": label,
           "key_averages_host_and_card": {"device_ops": ops, "device_busy_ms": busy_us / 1e3},
           "events_host_and_card": {"device_ops": sum(c for _, c in events),
                                    "device_busy_ms": sum(us for us, _ in events) / 1e3},
           "events_card_only": {"device_ops": card_only["device_ops"],
                                "device_busy_ms": card_only["device_busy_ms"]}}
    print("profile readings", json.dumps(row))
    return row


def k1_bound_ms(T, M, Q):
    """Least time for K1's work: (2Q+6) FP32 operations plus one exp (counted
    as one operation) per element (t, m, n) with m <= n (out is symmetric, so
    T M(M+1)/2 elements are all the function needs) at the FP32 peak, against
    each input read once and the output written once at the memory rate."""
    ops = T * M * (M + 1) // 2 * (2 * Q + 6 + 1)
    nbytes = 4 * (T + T * M + M * M + T * Q + M * Q + M * M)
    t_ops, t_bytes = ops / _FP32_OPS_PER_S, nbytes / _HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k1(psi2):
    """Phase 3: K1 against its plain version; returns per-shape results."""
    from rgp_tpu_torch.bench.psi2_times import device_per_call, time_cuda_ms
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES + _K2_STREAM_SHAPES[:1]):
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
        same = bit_identical(k, psi2.psi2_time_sum(*args32))
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum(*args32))
        dev_ms, per_call, names = device_per_call(lambda: psi2.psi2_time_sum(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_plain(*args32))
        bound_ms, bound_by = k1_bound_ms(T, M, Q)
        row = {
            "T": T, "M": M, "Q": Q,
            "max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / pmax),
            "worst_err_over_tol": float((err / tol).max()),
            "ms": k_ms, "device_ms": dev_ms, "launches_per_call": per_call, "bit_identical": same,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k1", json.dumps(row))
        check(ok, f"K1 disagrees with its plain version at (T,M,Q)={T, M, Q}: {row}")
        check(same, f"K1 gave different bits on a rerun at (T,M,Q)={T, M, Q}")
        check_one_launch(per_call, names, "psi2_fwd_kernel", (T, M, Q))
        check(bool(torch.equal(k, k.T)), f"K1's output is not exactly symmetric at (T,M,Q)={T, M, Q}")
        rows.append(row)
    return rows


def k2_bound_ms(T, M, Q):
    """Least time for K2's work at the FP32 peak, against the inputs (base,
    E, D1, w, Z, g, out) read once and the outputs (dbase, dE, dD1, dw, dzC)
    written once. PGs = P (g + g^T) is symmetric in (m, n), so the function
    needs per timestep M(M-1)/2 pairs m < n at (6Q+10) operations plus one
    exp (C once, the exp's argument and the product with Gs once, S and dE
    for both rows) and M diagonal elements at (4Q+8) plus one exp; then
    2Q per (t, m) each for dw and dzC, and g + g^T and -out g per (m, n)."""
    per_t = M * (M - 1) // 2 * (6 * Q + 10 + 1) + M * (4 * Q + 8 + 1)
    ops = T * per_t + 4 * T * M * Q + 2 * M * M
    nbytes = 4 * (2 * T + 2 * T * M + 4 * M * M + 2 * T * Q + 2 * M * Q)
    t_ops, t_bytes = ops / _FP32_OPS_PER_S, nbytes / _HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _within(k, p, rel=3e-4, rel_max=3e-5):
    """(ok, max_abs_err, worst err/tol) for |k - p| <= rel |p| + rel_max max|p|."""
    err = (k.double() - p).abs()
    tol = rel * p.abs() + rel_max * p.abs().max()
    ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
    return ok, float(err.max()), float((err / tol.clamp(min=1e-300)).max())


def phase_k2(psi2):
    """Phase 3b: K2 against its plain version at K1's shapes and at shapes it
    streams, all five outputs, with a random cotangent; a transposed and an
    expanded cotangent against their dense copies; returns per-shape
    results."""
    from rgp_tpu_torch.bench.psi2_times import device_per_call, time_cuda_ms
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES + _K2_STREAM_SHAPES):
        rng = np.random.default_rng(200 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        G = torch.as_tensor(rng.standard_normal((M, M)), device=dev)
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args32 = [x.to(torch.float32).contiguous() for x in (*pre, Z, G)]
        args32.append(psi2.psi2_time_sum(*args32[:5]))  # out, which dD1 reads
        args64 = [x.to(torch.float64) for x in args32]

        k = psi2.psi2_time_sum_bwd(*args32)
        torch.cuda.synchronize()
        ref = psi2.psi2_time_sum_bwd_plain(*args64)
        per = {}
        for name, a, b in zip(("dbase", "dE", "dD1", "dw", "dzC"), k, ref):
            ok, err, worst = _within(a, b)
            per[name] = {"ok": ok, "max_abs_err": err, "max_rel_err": err / float(b.abs().max()),
                         "worst_err_over_tol": worst}
        same = bit_identical(k, psi2.psi2_time_sum_bwd(*args32))
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd(*args32))
        dev_ms, per_call, names = device_per_call(lambda: psi2.psi2_time_sum_bwd(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd_plain(*args32))
        bound_ms, bound_by = k2_bound_ms(T, M, Q)
        if i == 0:  # the cotangent is read through its strides
            g32, out32 = args32[5], args32[6]
            for label, g in (("transposed", g32.T), ("expanded", g32[:1, :1].expand(M, M))):
                same_g = bit_identical(psi2.psi2_time_sum_bwd(*args32[:5], g, out32),
                                       psi2.psi2_time_sum_bwd(*args32[:5], g.contiguous(), out32))
                check(same_g, f"K2 with a {label} cotangent differs from its dense copy")
        row = {
            "T": T, "M": M, "Q": Q, "outputs": per, "plan": psi2.bwd_plan(M, Q),
            "max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "max_rel_err": max(v["max_rel_err"] for v in per.values()),
            "ms": k_ms, "device_ms": dev_ms, "launches_per_call": per_call, "bit_identical": same,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k2", json.dumps(row))
        check(all(v["ok"] for v in per.values()),
              f"K2 disagrees with its plain version at (T,M,Q)={T, M, Q}: {per}")
        check(same, f"K2 gave different bits on a rerun at (T,M,Q)={T, M, Q}")
        check_one_launch(per_call, names, "psi2_bwd_kernel", (T, M, Q))
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
        profile_readings(lambda: rgp.predict_train(cfg, params, Y, U), "predict_train")
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


def _harness_run(harness, task, method, **kw):
    """One ``harness.run``, its kept fit returned beside the record; every
    loss must be finite and the last ELBO above the first."""
    out, fit = harness.run(task, method, return_fit=True, **kw)
    losses = fit.res.losses.double().cpu().numpy()
    check(losses.shape == (kw["iters"],) and bool(np.isfinite(losses).all()), f"{method}: a loss is not finite")
    check(-losses[-1] > -losses[0], f"{method} did not raise the ELBO: {-losses[0]} -> {-losses[-1]}")
    return out, fit


def _steady_steps(fit, label, steps=10):
    """Host time per Adam step of the fit's own loss from its trained point,
    then one profiled run of ``steps``."""
    from rgp_tpu_torch import train

    def run():
        return train.fit_adam(fit.loss, fit.res.params, iters=steps, learning_rate=1e-2)

    ms = time_host_ms(run, n=3) / steps
    return ms, profile_device(run, label, steps)


def phase_configs_2_3(psi2, psi_stats):
    """Phase 7: configs 2 and 3 through the benchmark harness in float32 on
    the card, the counts set to 0 just before each run and read just after."""
    from rgp_tpu_torch.bench import harness

    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    c2, fit2 = _harness_run(harness, "drives", "rgp2_mlp", iters=_CONFIG2_STEPS, restarts=1)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    print("config2 launches", json.dumps({**counts, "steps": _CONFIG2_STEPS}))
    n_layers = fit2.cfg.n_hidden + 1  # two hidden layers and the output
    check(n_layers == 3, f"config 2 has {n_layers} psi layers, want 3")
    check(counts["k2"] == n_layers * _CONFIG2_STEPS,
          f"config 2: K2 launched {counts['k2']} times in {_CONFIG2_STEPS} steps, want {n_layers} per step")
    check(counts["k1"] >= n_layers * _CONFIG2_STEPS,
          f"config 2: K1 launched {counts['k1']} times in {_CONFIG2_STEPS} steps, want >= {n_layers} per step")
    check(counts["plain_psi2_calls"] == 0, f"config 2 took the plain Psi2 path {counts['plain_psi2_calls']} times")

    # the harness's own freerun over the 250 test steps: finite means,
    # positive variances (its record gives only the RMSE)
    fm, fv = fit2.means, fit2.vars
    check(fm.shape == (250, 1) and bool(torch.isfinite(fm).all() and (fv > 0).all()),
          "config 2 freerun: non-finite mean or non-positive variance")

    ms_step, prof = _steady_steps(fit2, "config2 training steps")
    row = {"config": "rgp2_mlp drives T=250 M=100 float32, cosine decay 1e-2 -> 1e-4",
           "steps": _CONFIG2_STEPS, "iters_per_s_harness": c2["iters_per_sec"], "ms_per_step_steady": ms_step,
           "elbo_first": c2["elbo_first"], "elbo_last": c2["elbo_last"], "freerun_rmse": c2["freerun_rmse"],
           "zero_predictor_rmse": c2["zero_predictor_rmse"], "degenerate_reasons": c2["degenerate_reasons"],
           "wall_seconds": c2["wall_seconds"], "device_busy_share": prof["device_busy_share"],
           "device_ops_per_step": prof["device_ops_per_step"]}
    print("config2", json.dumps(row))
    print("config2 harness", json.dumps(c2))

    for method in ("gp_narx", "gp_narx_matern"):
        c3, fit3 = _harness_run(harness, "actuator", method, iters=_CONFIG3_STEPS, num_inducing=50)
        print("config3", json.dumps({k: c3[k] for k in (
            "method", "iters", "iters_per_sec", "wall_seconds", "elbo_first", "elbo_last", "freerun_rmse",
            "zero_predictor_rmse", "degenerate_reasons", "final_noise_min")}))
        check(np.isfinite(c3["freerun_rmse"]), f"config 3 {method}: freerun RMSE not finite")
        if method == "gp_narx":  # config 3's steady steps (RBF), as for config 2
            ms3, prof3 = _steady_steps(fit3, "config3 training steps")
            print("config3 steady", json.dumps({"method": method, "ms_per_step_steady": ms3,
                                                "device_busy_share": prof3["device_busy_share"],
                                                "device_ops_per_step": prof3["device_ops_per_step"]}))
    return counts


def _c4_steady(method, fit, data, steps=10):
    """Host time per training step of a config-4 route from its trained
    point, through the training loop the route uses (``fit_adam`` at a fixed
    whitening for the exact route, ``fit_minibatch`` at batch 512 with the
    clip, and the natural-gradient block for the SVGP routes; the EMA route's
    plain minibatch loss), then one profiled run of ``steps``."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.inference.collapsed_vi import whitening_basis

    p0 = fit.res.params
    if method == "gp_narx_collapsed":
        with torch.no_grad():
            wh = whitening_basis(fit.cfg.kernel.K(p0["kern"], p0["Z"]))

        def run():
            return train.fit_adam(lambda q: fit.loss(q, wh), p0, iters=steps, learning_rate=1e-4)
    else:
        ng = {"natgrad_block": "qu", "natgrad_lr": 0.005} if method.startswith("svgp") else {}

        def run():
            return train.fit_minibatch(fit.loss, p0, data, iters=steps, batch_size=_C4_BATCH, seed=1,
                                       learning_rate=1e-4, clip_norm=10.0, **ng)

    ms = time_host_ms(run, n=3) / steps
    return ms, profile_device(run, f"config4 {method} training steps", steps)


def phase_config4(psi2, psi_stats, card):
    """Phase 8: config 4's five routes through the harness in float32 on the
    card, the counts set to 0 just before and read just after the runs."""
    from rgp_tpu_torch.bench import harness
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.data.windows import narx_design

    d = datasets.standardized_tensors(datasets.long_corpus(), dtype=torch.float32)
    X, Yt = narx_design(d.Y, d.U, 10, 5)
    data = {"X": X, "Y": Yt}
    n_test = d.U_test.shape[0]
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    fits = {}
    for method, steps in _C4_ROUTES.items():
        kw = {} if method == "gp_narx_collapsed" else {"batch_size": _C4_BATCH}
        rec, fit = harness.run("long_corpus", method, iters=steps, return_fit=True, **kw)
        print("config4 harness", json.dumps(rec))
        losses = fit.res.losses.double().cpu().numpy()
        check(losses.shape == (steps,), f"{method}: {losses.shape[0]} losses for {steps} steps")
        if method != "gp_narx_minibatch_ema":
            check(bool(np.isfinite(losses).all()), f"{method}: a loss is not finite")
            check(-losses[-1] > -losses[0], f"{method} did not raise the ELBO: {-losses[0]} -> {-losses[-1]}")
            check(fit.means.shape == (n_test, 1) and bool(torch.isfinite(fit.means).all()
                                                          and (fit.vars > 0).all()),
                  f"{method} freerun: non-finite mean or non-positive variance")
        fits[method] = (rec, fit)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    print("config4 launches", json.dumps({**counts, "steps": sum(_C4_ROUTES.values())}))
    check(counts == {"k1": 0, "k2": 0, "plain_psi2_calls": 0},
          f"config 4 (certain inputs) reached the Psi2 time sum: {counts}")

    for method, (rec, fit) in fits.items():
        ms, prof = _c4_steady(method, fit, data)
        row = {"method": method, "steps": rec["iters"], "cut": "300 of all.py's 1000 quick-budget steps"
               if rec["iters"] == 300 else None, "batch_size": None if method == "gp_narx_collapsed" else _C4_BATCH,
               "iters_per_s_harness": rec["iters_per_sec"], "wall_seconds": rec["wall_seconds"],
               "ms_per_step_steady": ms, "device_ops_per_step": prof["device_ops_per_step"],
               "device_busy_share": prof["device_busy_share"], "elbo_first": rec["elbo_first"],
               "elbo_last": rec["elbo_last"], "freerun_rmse": rec["freerun_rmse"],
               "zero_predictor_rmse": rec["zero_predictor_rmse"], "degenerate_reasons": rec["degenerate_reasons"],
               "final_noise_min": rec["final_noise_min"], "card": card}
        if method in _C4_TIMED_FREERUNS:
            row["freerun_steps"] = n_test
            row["freerun_wall_s"] = time_host_ms(fit.freerun, n=1) / 1e3
        print("config4", json.dumps(row))
    return counts


def phase_svgp_uncertain(psi2, psi_stats):
    """Phase 8b: one ``svgp.elbo`` with uncertain inputs, forward and
    backward, on float32 CUDA tensors: exactly one K1 and one K2 launch. The
    Psi2 that K1 gave inside it is held against the plain version in float64
    at K1's tolerance, and the gradient of Z through K2 (the VJP of the Psi2
    sum at the cotangent the bound handed K2) against the plain float64 VJP
    at the same cotangent at K2's; the ELBO against the float64 plain bound at
    K1's relative 2e-4. The whole gradient of Z is printed against the
    float64 plain one beside the float32 plain one's error: the float32
    bound's Z gradient is a sum of path contributions ~10x its size, so its
    rounding alone exceeds K2's tolerance, kernel or no kernel (CPU: float32
    plain against float64, 55x). Returns the launch counts."""
    from rgp_tpu_torch.inference import svi
    from rgp_tpu_torch.kernels import RBF
    from rgp_tpu_torch.models import svgp
    from rgp_tpu_torch.ops.psi_stats import PsiStats, psi01

    T, M, Q = _SVGP_UNCERTAIN
    dev = torch.device("cuda")
    rng = np.random.default_rng(400)
    X = torch.as_tensor(rng.standard_normal((T, Q)), dtype=torch.float32, device=dev)
    Xv = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), dtype=torch.float32, device=dev)
    Y = torch.sin(X.sum(-1, keepdim=True) / math.sqrt(Q))
    cfg = svgp.SVGPConfig(RBF(input_dim=Q), M)
    # lengthscale sqrt(Q) keeps Psi2 entries O(1) at this width
    params = svgp.init_params(cfg, X, seed=0, lengthscale=math.sqrt(Q))

    # the Psi2 that svgp.elbo's K1 produces, kept to read its cotangent
    captured = []
    kernel_sum = psi_stats.rbf_psi2_sum

    def capture(*args):
        out = kernel_sum(*args)
        out.retain_grad()
        captured.append(out)
        return out

    Z = params["Z"].clone().requires_grad_(True)
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    psi_stats.rbf_psi2_sum = capture
    try:
        e = svgp.elbo(cfg, {**params, "Z": Z}, X, Y, X_var=Xv)
        e.backward()
        e = e.detach()
    finally:
        psi_stats.rbf_psi2_sum = kernel_sum
    torch.cuda.synchronize()
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    check(counts == {"k1": 1, "k2": 1, "plain_psi2_calls": 0} and len(captured) == 1,
          f"svgp.elbo with uncertain inputs: launches {counts}, want one K1 and one K2")
    psi2_k, G = captured[0].detach(), captured[0].grad

    def plain_bound(dtype):
        q = _cast(params, dtype)
        Zp = q["Z"].clone().requires_grad_(True)
        mu, s, y = X.to(dtype), Xv.to(dtype), Y.to(dtype)
        psi0, psi1 = psi01(cfg.kernel, q["kern"], Zp, mu, s)
        p2 = psi_stats._rbf_psi2_sum_chunked(q["kern"], Zp, mu, s, 128)
        ep = svi.svi_bound(cfg.kernel, q["kern"], Zp, q["log_noise"], q["qu"], PsiStats(psi0, psi1, p2), y)
        (gz,) = torch.autograd.grad(ep, Zp)
        return ep.detach(), gz, p2.detach()

    e64, gz64, psi2_64 = plain_bound(torch.float64)
    _, gz32, _ = plain_bound(torch.float32)
    ok_k1, err_k1, worst_k1 = _within(psi2_k, psi2_64, rel=2e-4, rel_max=2e-5)
    # the gradient of Z through the Psi2 sum at the bound's cotangent G:
    # K2 (float32) against the plain float64 VJP of the same sum
    q64 = _cast(params, torch.float64)
    Zk = params["Z"].clone().requires_grad_(True)
    (vjp_k,) = torch.autograd.grad(psi2.rbf_psi2_sum(params["kern"], Zk, X, Xv), Zk, grad_outputs=G)
    Z64 = q64["Z"].clone().requires_grad_(True)
    (vjp_64,) = torch.autograd.grad(
        psi_stats._rbf_psi2_sum_chunked(q64["kern"], Z64, X.double(), Xv.double(), 128), Z64,
        grad_outputs=G.double())
    ok_k2, err_k2, worst_k2 = _within(vjp_k, vjp_64)
    rel_e = abs(float(e) - float(e64)) / abs(float(e64))
    err_total = float((Z.grad.double() - gz64).abs().max())
    err_total32 = float((gz32.double() - gz64).abs().max())
    row = {"T": T, "M": M, "Q": Q, "launches": counts, "elbo": float(e), "elbo_plain_f64": float(e64),
           "elbo_rel_err": rel_e, "psi2_k1": {"max_abs_err": err_k1, "worst_err_over_tol": worst_k1},
           "grad_Z_through_k2": {"max_abs_err": err_k2, "worst_err_over_tol": worst_k2,
                                 "max_abs": float(vjp_64.abs().max())},
           "grad_Z_total": {"max_abs": float(gz64.abs().max()), "max_abs_err_k1k2_f32": err_total,
                            "max_abs_err_plain_f32": err_total32}}
    print("svgp uncertain elbo", json.dumps(row))
    check(bool(torch.isfinite(e)) and rel_e <= 2e-4, f"svgp.elbo through K1 {float(e)} vs plain {float(e64)}")
    check(ok_k1, f"svgp.elbo's Psi2 from K1 disagrees with the plain version: worst err/tol {worst_k1}")
    check(ok_k2, f"svgp.elbo's grad Z through K2 disagrees with the plain VJP: worst err/tol {worst_k2}")
    check(bool(torch.isfinite(Z.grad).all()), "svgp.elbo's grad Z is not finite")
    return counts


def _c5_counts(psi2, psi_stats):
    return {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}


def _c5_zero(psi2, psi_stats):
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0


def phase_config5_potential(psi2, psi_stats, root, card):
    """Phase 9a: the config-5 potential at the anchor (float64) and at 128
    of the JAX package's draws, batched, on both Psi2 routes (float32).
    Returns the launch counts of the ``auto`` route's one batched
    value-and-gradient."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.sample.api import make_rgp_potential
    from rgp_tpu_torch.sample.hmc import value_and_grad

    dev = torch.device("cuda")
    anchor = os.path.join(root, _C5_ANCHOR)
    cfg, p64, Y64, U64, _, _ = _flagship(0, torch.float64, anchor)
    pot64, flat64, _, b64 = make_rgp_potential(cfg, p64, Y64, U64, block=64, psi_prefer="scan",
                                                fixed_whitening=True)
    with torch.no_grad():
        u_anchor = float(pot64(flat64))
    print("config5 anchor", json.dumps({"U_f64_frozen": u_anchor, "artifact": _C5_U_ANCHOR, "card": card}))
    check(abs(u_anchor - _C5_U_ANCHOR) <= 0.05,
          f"frozen f64 potential at the anchor {u_anchor}, surrogate_check_r5.json has {_C5_U_ANCHOR}")

    with np.load(os.path.join(root, _C5_TPU_DRAWS)) as z:
        points = z["draws"][:_C5_CHAINS, -1]  # the last draw of each of the first 128 chains
    Z64 = torch.tensor(points, dtype=torch.float64, device=dev)
    # float64 reference, 32 chains at a time (no per-chunk recompute under vmap)
    ref = [value_and_grad(b64, Z64[i:i + 32]) for i in range(0, _C5_CHAINS, 32)]
    u64, g64 = torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref])
    del ref, b64, pot64

    cfg32, p32, Y32, U32, _, _ = _flagship(0, torch.float32, anchor)
    Z32 = torch.tensor(points, dtype=torch.float32, device=dev)
    rows, counts = {}, {}
    for route in ("scan", "auto"):
        _, _, _, batched = make_rgp_potential(cfg32, p32, Y32, U32, block=32, psi_prefer=route,
                                              fixed_whitening=True)
        value_and_grad(batched, Z32)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _c5_zero(psi2, psi_stats)
        u, g = value_and_grad(batched, Z32)
        torch.cuda.synchronize()
        counts[route] = _c5_counts(psi2, psi_stats)
        peak = torch.cuda.max_memory_allocated()
        ms = time_host_ms(lambda: value_and_grad(batched, Z32), n=3)
        prof = profile_device(lambda: value_and_grad(batched, Z32), f"config5 potential {route}", 1)
        u_err = (u.double() - u64).abs()
        g_err = (g.double() - g64).abs()
        rows[route] = {
            "route": route, "chains": _C5_CHAINS, "launches": counts[route], "ms_per_value_and_grad": ms,
            "device_ops": prof["device_ops"], "device_busy_share": prof["device_busy_share"],
            "peak_memory_bytes": peak, "value_max_abs_err_vs_f64": float(u_err.max()),
            "value_median_abs_err_vs_f64": float(u_err.median()), "grad_max_abs_err_vs_f64": float(g_err.max()),
            "grad_max_abs_f64": float(g64.abs().max()), "finite": bool(torch.isfinite(u).all()
                                                                       and torch.isfinite(g).all()),
            "card": card,
        }
        print("config5 potential", json.dumps(rows[route]))
        del batched
        torch.cuda.empty_cache()
    n_layers = cfg32.n_hidden + 1
    check(counts["auto"] == {"k1": n_layers * _C5_CHAINS, "k2": n_layers * _C5_CHAINS, "plain_psi2_calls": 0},
          f"auto potential at {_C5_CHAINS} chains: launches {counts['auto']}, want one K1 and one K2 per "
          f"chain per layer and no plain path")
    check(counts["scan"]["k1"] == 0 and counts["scan"]["k2"] == 0 and counts["scan"]["plain_psi2_calls"] > 0,
          f"scan potential: launches {counts['scan']}, want the plain path only")
    plain = rows["scan"]
    check(plain["value_median_abs_err_vs_f64"] <= 1.0,
          f"config 5 plain float32 potential: median {plain['value_median_abs_err_vs_f64']} nats from float64")
    for route, row in rows.items():
        check(row["finite"], f"config 5 {route} potential: non-finite value or gradient")
        for what in ("value", "grad"):
            key = f"{what}_max_abs_err_vs_f64"
            check(row[key] <= 2.0 * plain[key],
                  f"config 5 {route} potential: {what} error {row[key]} above twice the plain float32 "
                  f"route's {plain[key]}")
    return counts["auto"]


def phase_config5_nuts(psi2, psi_stats, root, card):
    """Phase 9b: the NUTS twin at half the quick budget, the JAX protocol."""
    from rgp_tpu_torch.bench.posterior_check import compare_draws
    from rgp_tpu_torch.bench.sampling import bench_nuts

    _c5_zero(psi2, psi_stats)
    rec, draws, diverging = bench_nuts(_C5_CHAINS, _C5_WARMUP, _C5_DRAWS, 6, 0,
                                       params_npz=os.path.join(root, _C5_ANCHOR), return_draws=True)
    counts = _c5_counts(psi2, psi_stats)
    print("config5 nuts launches", json.dumps(counts))
    print("config5 nuts", json.dumps(rec))
    for path, note in ((_C5_TPU_DRAWS, "the same f32 frozen-basis surrogate"),
                       (_C5_CPU_DRAWS, "f64 fresh-basis chain, another surrogate: information only")):
        with np.load(os.path.join(root, path)) as z:
            stats = compare_draws(draws, diverging, z["draws"], z["diverging"])
        print("config5 nuts moments", json.dumps({"against": path, "note": note, **stats, "card": card}))
    check(draws.shape == (_C5_CHAINS, _C5_DRAWS, 25) and bool(np.isfinite(draws).all()),
          f"config 5 NUTS: draws of shape {draws.shape}, or not finite")
    eps = rec["details"]["step_size_per_group"]
    check(min(eps) >= 1e-2, f"config 5 NUTS: the step size collapsed to {eps}")
    # scan: K1 only for the frozen whitening's ladder pass at the anchor, one per layer
    check(counts["k1"] == 2 and counts["k2"] == 0, f"config 5 NUTS twin (scan) launches: {counts}")
    return rec


def phase_config5_sample_nuts(psi2, psi_stats, root, card):
    """Phase 9c: the port's own few-chain config-5 path through K1/K2."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.sample.api import sample_nuts

    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR))
    _c5_zero(psi2, psi_stats)
    t0 = time.perf_counter()
    res = sample_nuts(cfg, params, Y, U, 0, n_samples=4, n_warmup=6, n_chains=4, max_depth=5,
                      hessian_precondition=True)
    s = res.samples.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = _c5_counts(psi2, psi_stats)
    row = {"chains": 4, "n_warmup": 6, "n_samples": 4, "max_depth": 5, "wall_seconds": wall,
           "launches": counts, "mean_accept": float(res.accept_prob.mean()),
           "divergence_rate": float(res.diverging.double().mean()), "step_size": float(res.step_size),
           "card": card}
    print("config5 sample_nuts", json.dumps(row))
    check(bool(np.isfinite(s).all()), "config 5 sample_nuts: a draw is not finite")
    check(counts["k1"] > 0 and counts["k2"] > 0, f"config 5 sample_nuts did not reach K1 and K2: {counts}")
    return counts


def phase_config5_smc(card):
    """Phase 9d: the SMC twin at 1024 particles."""
    from rgp_tpu_torch.bench.sampling import bench_smc

    rec, res = bench_smc(_C5_SMC_PARTICLES, 300, return_result=True)
    print("config5 smc", json.dumps({**rec, "min_ess": float(res.ess_history.min()), "card": card}))
    check(bool(torch.isfinite(res.log_marginal)), f"config 5 SMC: log-marginal {float(res.log_marginal)}")
    check(bool((res.ess_history > 0).all()), "config 5 SMC: a step's ESS is 0")
    return rec


def _tempered_particles(flat0, n, seed=0):
    """``n`` draws from ``sample_tempered``'s prior: N(flat0, 3^2), on a
    generator on the card."""
    gen = torch.Generator(device=flat0.device).manual_seed(seed)
    return flat0[None, :] + _C5_PRIOR_STD * torch.randn((n, flat0.shape[0]), generator=gen, dtype=flat0.dtype,
                                                         device=flat0.device)


def _ladder_rung(wh):
    """The floor ladder's rung behind the whitening ``wh`` as a 0-d tensor (0,
    1 or 2 for the spectral floor times 1, 1e3, 1e6), read off the basis:
    where the floor clamps the spectrum, lambda_eff's smallest over its
    largest is the floor. -1 where it clamps nothing. Tensor dataflow only, so
    it runs under ``torch.func.vmap``."""
    from rgp_tpu_torch.inference.collapsed_vi import default_spectral_floor

    lam_eff = 1.0 / (wh.W * wh.W).sum(0)
    rung = torch.round(torch.log10(lam_eff.min() / lam_eff.max() / default_spectral_floor(wh.W.dtype)) / 3.0)
    return torch.where((wh.topup > 0).any(), rung, torch.full_like(rung, -1.0))


def _batched_rungs(cfg, params, Y, U, V, route, block=32):
    """One batched tempered log-likelihood of the particles ``V`` on a route
    (``auto`` reads Psi2 from K1, ``scan`` from the plain path summed in
    chunks of ``block`` time steps), with the
    rung each ladder took for each particle in that batch: per layer, the
    whitening's floor rung (see :func:`_ladder_rung`), then the jitter rungs
    (0, 3, 7 for the base jitter times 1, 1e3, 1e7) of its two Cholesky
    factorizations, Kt's and Ct's. The ladders are read by spies put in
    place of ``whitening_basis`` and ``jitchol`` in ``collapsed_vi``, where
    the bound looks them up. Returns (values (N,), rungs (N, 3 x layers))."""
    from rgp_tpu_torch import linalg
    from rgp_tpu_torch.inference import collapsed_vi
    from rgp_tpu_torch.sample.api import _hyper_elbo

    records = []
    basis, chol = collapsed_vi.whitening_basis, collapsed_vi.jitchol

    def spy_basis(*args, **kw):
        wh = basis(*args, **kw)
        records.append(_ladder_rung(wh))
        return wh

    def spy_chol(A, jitter0=1e-6):
        L, jitter = linalg.jitchol_with_jitter(A, jitter0)
        scale = torch.clamp(torch.diagonal(A).mean(), min=1e-30)
        records.append(torch.round(torch.log10(jitter / (jitter0 * scale))))
        return L

    hyper_elbo = _hyper_elbo(cfg, params, Y, U, block=None if route == "auto" else block, psi_prefer=route)[0]
    n_rungs = 3 * (cfg.n_hidden + 1)

    def one(v):
        records.clear()
        value = hyper_elbo(v, False)
        check(len(records) == n_rungs, f"the rung spies read {len(records)} ladders, want {n_rungs}: the bound "
              f"no longer looks up whitening_basis and jitchol in collapsed_vi")
        return value, torch.stack(records)

    collapsed_vi.whitening_basis, collapsed_vi.jitchol = spy_basis, spy_chol
    try:
        with torch.no_grad():
            return torch.func.vmap(one)(V)
    finally:
        collapsed_vi.whitening_basis, collapsed_vi.jitchol = basis, chol


def _psi2_batch(cfg, params, Y, U, unravel, V, route):
    """Each layer's Psi2 time sum at every particle of ``V`` on a route,
    batched as the log-likelihood batches it: a tuple of (N, M, M)."""
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.sample.api import merge_hypers

    def one(v):
        p = merge_hypers(params, unravel(v))
        return tuple(stats.psi2 for _, _, stats, *_ in
                     rgp._layer_stats(cfg, p, Y, U, None if route == "auto" else 32, route, False))

    with torch.no_grad():
        return torch.func.vmap(one)(V)


def _psi2_worst(psi2_32, psi2_64, rel=2e-4, rel_max=2e-5):
    """Per particle and layer, the worst |x - x64| over ``_within``'s
    tolerance rel |x64| + rel_max max|x64| (inf where x is not finite):
    (N, layers)."""
    cols = []
    for a, b in zip(psi2_32, psi2_64):
        tol = rel * b.abs() + rel_max * b.abs().amax((1, 2), keepdim=True)
        worst = ((a.double() - b).abs() / tol.clamp(min=1e-300)).amax((1, 2))
        cols.append(torch.where(torch.isfinite(a).flatten(1).all(1), worst, torch.full_like(worst, math.inf)))
    return torch.stack(cols, 1)


def phase_tempered_loglik(psi2, psi_stats, root, card):
    """Phase 10a: one batched tempered log-likelihood at 512 particles from
    ``sample_tempered``'s prior around the anchor, on both Psi2 routes
    (float32), held against each other and against float64 at every
    particle. Returns the launch counts of the ``auto`` route's call."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.params import leaves_with_paths, positive, with_leaves
    from rgp_tpu_torch.sample.api import make_rgp_loglik

    anchor = os.path.join(root, _C5_ANCHOR)
    cfg, p32, Y32, U32, _, _ = _flagship(0, torch.float32, anchor)
    n_layers = cfg.n_hidden + 1
    out, counts, rows = {}, {}, {}
    for route in ("auto", "scan"):
        loglik, flat0, unravel = make_rgp_loglik(cfg, p32, Y32, U32, psi_prefer=route,
                                                 block=None if route == "auto" else 32)
        V = _tempered_particles(flat0, _C5_TEMPERED_PARTICLES)  # the same draws on both routes
        loglik(V)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _c5_zero(psi2, psi_stats)
        out[route] = loglik(V)
        torch.cuda.synchronize()
        counts[route] = _c5_counts(psi2, psi_stats)
        peak = torch.cuda.max_memory_allocated()
        ms = time_host_ms(lambda: loglik(V), n=3)
        prof = profile_device(lambda: loglik(V), f"tempered loglik {route}", 1)
        rows[route] = {"route": route, "particles": _C5_TEMPERED_PARTICLES, "launches": counts[route],
                       "ms_per_call": ms, "device_ops": prof["device_ops"],
                       "device_busy_share": prof["device_busy_share"], "peak_memory_bytes": peak,
                       "non_finite": int((~torch.isfinite(out[route])).sum()), "card": card}
        print("tempered loglik", json.dumps(rows[route]))
        del loglik
        torch.cuda.empty_cache()
    check(counts["auto"] == {"k1": n_layers * _C5_TEMPERED_PARTICLES, "k2": 0, "plain_psi2_calls": 0},
          f"tempered loglik auto at {_C5_TEMPERED_PARTICLES} particles: launches {counts['auto']}, want one K1 per "
          f"particle per layer, no K2 and no plain path")
    check(counts["scan"]["k1"] == 0 and counts["scan"]["k2"] == 0 and counts["scan"]["plain_psi2_calls"] > 0,
          f"tempered loglik scan: launches {counts['scan']}, want the plain path only")

    # Every particle again, on both float32 routes and on the plain route in
    # float64 at the same float32 inputs (the anchor and the draws widened, so
    # that only the arithmetic differs), with the rungs each ladder took. The
    # float32 rung passes must give the timed calls' bits. Where all three
    # take the same rungs, the float32 routes evaluate float64's regularized
    # model and are held to it. The prior's draws reach ELBOs of -1e6, where
    # float32 is tens of nats off float64, so the gaps are relative,
    # |x - e64| / (1 + |e64|) as in the repo's f32-lane gate, under phase 9a's
    # rule: the plain float32 route's median gap within the lane's 1e-3, and
    # its gaps the yardstick of the kernel route's over the same particles.
    # Near a rung's edge the factor at that rung is near-singular in float32,
    # so even there a route's value follows the rounding of Psi2 by up to a
    # few tenths relative. A particle whose rungs differ evaluates another
    # model (float32 rounding decides a trial Cholesky), a cliff of up to
    # thousands of nats: it is counted and printed, and K1's Psi2 is held to
    # float64 there as at every other particle.
    p64 = with_leaves(p32, [x.double() for _, x in leaves_with_paths(p32)])
    Y64, U64 = Y32.double(), U32.double()
    _, _, unravel64 = make_rgp_loglik(cfg, p64, Y64, U64, psi_prefer="scan", block=32)
    batch, rungs = {}, {}
    for route in out:
        batch[route], rungs[route] = _batched_rungs(cfg, p32, Y32, U32, V, route)
    e64, rungs["f64"] = _batched_rungs(cfg, p64, Y64, U64, V.double(), "scan")
    # the plain route again with another order of the same float32 sum (time
    # chunks of 64), to show how far rounding order alone moves the bound
    scan64, rungs["scan_block64"] = _batched_rungs(cfg, p32, Y32, U32, V, "scan", block=64)
    torch.cuda.empty_cache()
    same_bits = {route: bool(torch.equal(batch[route], out[route])) for route in out}
    route_flip = (rungs["auto"] != rungs["scan"]).any(1)
    dtype_flip = (rungs["scan"] != rungs["f64"]).any(1)
    ok64 = torch.isfinite(e64)
    same = ok64 & ~route_flip & ~dtype_flip
    same_order = same & (rungs["scan_block64"] == rungs["scan"]).all(1)
    rel = {route: (batch[route].double() - e64).abs() / (1.0 + e64.abs()) for route in out}
    gap = (batch["auto"].double() - batch["scan"].double()).abs() / (1.0 + batch["scan"].double().abs())
    gap_order = (scan64.double() - batch["scan"].double()).abs() / (1.0 + batch["scan"].double().abs())

    # K1's Psi2 at every particle against the plain float64 Psi2, in units of
    # K1's tolerance. Lengthscales of e^-6 from the prior amplify float32
    # rounding past that tolerance on the plain path too, so the plain
    # float32 Psi2 is the yardstick, particle by particle as phase 9a's rule
    # holds a route: K1 within twice its error, or within the tolerance
    psi2_64 = _psi2_batch(cfg, p64, Y64, U64, unravel64, V.double(), "scan")
    k1_worst = _psi2_worst(_psi2_batch(cfg, p32, Y32, U32, unravel, V, "auto"), psi2_64)
    plain_worst = _psi2_worst(_psi2_batch(cfg, p32, Y32, U32, unravel, V, "scan"), psi2_64)
    del psi2_64
    torch.cuda.empty_cache()

    def detail(i):
        hyp = unravel64(V[i].double())
        betas = [float(1.0 / positive(rgp._fln(cfg, h["log_noise"])))
                 for h in [*hyp["layers"], hyp["out"]]]
        return {"particle": i, "auto": float(batch["auto"][i]), "scan": float(batch["scan"][i]),
                "scan_block64": float(scan64[i]), "f64": float(e64[i]),
                "rungs_auto": rungs["auto"][i].int().tolist(),
                "rungs_scan": rungs["scan"][i].int().tolist(),
                "rungs_scan_block64": rungs["scan_block64"][i].int().tolist(), "rungs_f64": rungs["f64"][i].int().tolist(),
                "beta_per_layer": betas, "k1_psi2_worst_err_over_tol": k1_worst[i].tolist(),
                "plain_psi2_worst_err_over_tol": plain_worst[i].tolist()}

    def argmax_at(x, mask):
        return int(torch.where(mask, x, torch.full_like(x, -1.0)).argmax())

    yard = float(rel["scan"][same].max())
    row = {"particles": _C5_TEMPERED_PARTICLES, "f64_finite": int(ok64.sum()),
           "value_f64_range": [float(e64[ok64].min()), float(e64[ok64].max())],
           "rung_pass_gives_the_same_bits": same_bits,
           "route_flips": int(route_flip.sum()), "f32_f64_flips": int((dtype_flip & ~route_flip).sum()),
           "same_rungs": int(same.sum()),
           "scan_vs_f64_rel": {"max_same_rungs": yard, "median": float(rel["scan"][ok64].median()),
                               "max": float(rel["scan"][ok64].max())},
           "auto_vs_f64_rel": {"max_same_rungs": float(rel["auto"][same].max()),
                               "median": float(rel["auto"][ok64].median()), "max": float(rel["auto"][ok64].max())},
           "auto_vs_scan_rel": {"max_same_rungs": float(gap[same].max()),
                                "median": float(gap[torch.isfinite(gap)].median())},
           "scan_block64_vs_scan_rel": {"same_rungs": int(same_order.sum()),
                                        "max_same_rungs": float(gap_order[same_order].max()),
                                        "median": float(gap_order[torch.isfinite(gap_order)].median())},
           "k1_psi2_vs_f64_worst_err_over_tol": float(k1_worst.max()),
           "plain_psi2_vs_f64_worst_err_over_tol": float(plain_worst.max()),
           "k1_psi2_over_yardstick": float((k1_worst / torch.clamp(2.0 * plain_worst, min=1.0)).max()),
           "plain_psi2_beyond_tol_particles": int((plain_worst > 1.0).any(1).sum()),
           "card": card}
    print("tempered loglik vs f64", json.dumps(row))
    for what, i in (("worst scan vs f64, same rungs", argmax_at(rel["scan"], same)),
                    ("worst auto vs f64, same rungs", argmax_at(rel["auto"], same)),
                    ("worst auto vs scan, same rungs", argmax_at(gap, same)),
                    ("worst scan block 64 vs scan, same rungs", argmax_at(gap_order, same_order)),
                    ("worst scan vs f64", argmax_at(rel["scan"], ok64))):
        print("tempered loglik worst", json.dumps({"what": what, **detail(i)}))
    for i in torch.nonzero(route_flip).flatten().tolist():
        print("tempered loglik flip", json.dumps(detail(i)))
    check(all(same_bits.values()), f"the rung passes do not give the timed calls' values: {same_bits}")
    check(int(ok64.sum()) == _C5_TEMPERED_PARTICLES,
          f"the float64 tempered log-likelihood is not finite at {_C5_TEMPERED_PARTICLES - int(ok64.sum())} "
          f"of {_C5_TEMPERED_PARTICLES} particles")
    k1_over = (k1_worst / torch.clamp(2.0 * plain_worst, min=1.0)).amax(1)
    check(row["k1_psi2_over_yardstick"] <= 1.0,
          f"K1's Psi2 is off the float64 plain Psi2 at particle {int(k1_over.argmax())}: "
          f"{detail(int(k1_over.argmax()))}, beyond twice the plain float32 Psi2's error and K1's tolerance")
    check(row["scan_vs_f64_rel"]["median"] <= 1e-3,
          f"plain float32 tempered log-likelihood: median relative gap {row['scan_vs_f64_rel']['median']} to "
          f"float64 (gate 1e-3)")
    check(row["auto_vs_f64_rel"]["median"] <= 2.0 * row["scan_vs_f64_rel"]["median"],
          f"auto tempered log-likelihood: median relative gap {row['auto_vs_f64_rel']['median']} to float64, "
          f"above twice the plain float32 route's {row['scan_vs_f64_rel']['median']}")
    check(row["auto_vs_f64_rel"]["max_same_rungs"] <= 2.0 * yard,
          f"auto tempered log-likelihood: relative gap {row['auto_vs_f64_rel']['max_same_rungs']} to float64 "
          f"where every route takes float64's rungs, above twice the plain float32 route's {yard} there")
    check(row["auto_vs_scan_rel"]["median"] <= 2.0 * row["scan_vs_f64_rel"]["median"],
          f"auto against scan at {_C5_TEMPERED_PARTICLES} particles: median relative gap "
          f"{row['auto_vs_scan_rel']['median']}, above twice the plain route's median gap to float64")
    return counts["auto"], rows


def phase_tempered_smc(psi2, psi_stats, root, card):
    """Phase 10b: ``sample_tempered`` at 512 particles with the reference's
    defaults on the anchor (float32, K1 through the vmap rule). Returns the
    launch counts."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.sample.api import merge_hypers, sample_tempered

    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR))
    n_layers = cfg.n_hidden + 1
    gen = torch.Generator(device=Y.device).manual_seed(0)
    _c5_zero(psi2, psi_stats)
    t0 = time.perf_counter()
    res, unravel = sample_tempered(cfg, params, Y, U, gen, n_particles=_C5_TEMPERED_PARTICLES,
                                   prior_std=_C5_PRIOR_STD, max_stages=50, ess_target=0.5, n_moves=3,
                                   step_scale=0.5)
    log_z = float(res.log_Z)  # the host read that ends the run
    wall = time.perf_counter() - t0
    counts = _c5_counts(psi2, psi_stats)
    evals = 1 + 3 * res.n_stages
    with torch.no_grad():
        e_anchor = float(rgp.elbo(cfg, params, Y, U, block=None))
        e_mean = float(rgp.elbo(cfg, merge_hypers(params, unravel(res.particles.mean(0))), Y, U, block=None))
    betas = res.betas[:res.n_stages].double().cpu()
    beta_final = float(res.beta_final)
    row = {"particles": _C5_TEMPERED_PARTICLES, "max_stages": 50, "ess_target": 0.5, "n_moves": 3,
           "step_scale": 0.5, "prior_std": _C5_PRIOR_STD, "log_Z": log_z, "n_stages": res.n_stages,
           "beta_final": beta_final, "truncated": beta_final < 1.0, "accept_rate": float(res.accept_rate),
           "wall_seconds": wall, "loglik_evaluations": evals, "evaluations_per_s": evals / wall,
           "particle_evaluations_per_s": evals * _C5_TEMPERED_PARTICLES / wall, "launches": counts,
           "elbo_anchor": e_anchor, "elbo_at_particle_mean": e_mean,
           "betas_head": betas[:5].tolist(), "card": card}
    print("tempered smc", json.dumps(row))
    if row["truncated"]:
        print(f"tempered smc: TRUNCATED at beta={beta_final:.6g} after {res.n_stages} stages; log_Z covers the "
              f"anneal up to it")
    check(counts == {"k1": n_layers * _C5_TEMPERED_PARTICLES * evals, "k2": 0, "plain_psi2_calls": 0},
          f"sample_tempered: launches {counts}, want {n_layers * _C5_TEMPERED_PARTICLES} K1 per evaluation "
          f"({evals}), no K2 and no plain path")
    check(math.isfinite(log_z), f"sample_tempered: log_Z {log_z}")
    check(res.n_stages >= 1 and bool((torch.diff(torch.cat([betas.new_zeros(1), betas])) > 0).all())
          and float(betas[-1]) == beta_final, f"sample_tempered: the beta schedule is not increasing: {betas}")
    check(0.0 < row["accept_rate"] <= 1.0, f"sample_tempered: accept rate {row['accept_rate']}")
    check(bool(torch.isfinite(res.particles).all()), "sample_tempered: a particle is not finite")
    check(e_mean > e_anchor - 50.0, f"sample_tempered: the ELBO at the particle mean {e_mean} is more than 50 nats "
          f"below the anchor's {e_anchor}")
    return counts


def phase_examples(psi2, psi_stats, card):
    """Phase 10c: the five example scripts in this process on the card, each
    at the cut size printed; each must print its JSON line."""
    import contextlib
    import importlib
    import io

    rows = {}
    for name, argv in _EXAMPLES:
        mod = importlib.import_module(f"rgp_tpu_torch.examples.{name}")
        _c5_zero(psi2, psi_stats)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            record = mod.main(argv)
        wall = time.perf_counter() - t0
        printed = buf.getvalue().strip().splitlines()
        check(bool(printed) and json.loads(printed[-1]) == json.loads(json.dumps(record)),
              f"example {name} did not print its JSON line")
        rows[name] = {"argv": argv, "wall_seconds": wall, "launches": _c5_counts(psi2, psi_stats),
                      "printed": printed, "card": card}
        print("example", json.dumps(rows[name]))
    return rows


def ptxas_report(log):
    """{compile-time Q width: {"registers", "spill_bytes"}} of each kernel
    instance, from the ptxas report nvcc wrote beside the library."""
    import re

    out, width = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelILi(\d+)E", line)
        if m:
            width = int(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and width is not None:
            out.setdefault(width, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and width is not None:
            out.setdefault(width, {})["registers"] = int(m.group(1))
    return out


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

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s wall")
        return out

    # phase 2
    t0 = time.perf_counter()
    libs = psi2.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build (K1 and K2 at once): {build_s:.1f} s")
    print(f"phase 2: {build_s:.1f} s wall")
    ptxas = {}
    for name, so in libs.items():
        print(f"  {name}: {os.path.relpath(so, root)}")
        log = so.with_suffix(".log")
        ptxas[name] = ptxas_report(log.read_text()) if log.exists() else "not reported"
        print(f"  ptxas {name} (Q width: registers, spill bytes):", json.dumps(ptxas[name]))

    k1_rows = timed("3 (K1)", phase_k1, psi2)
    k2_rows = timed("3 (K2)", phase_k2, psi2)
    timed("3 (VJP)", phase_vjp, psi2, psi_stats)
    serving = timed("4", phase_serving, psi2, psi_stats)
    timed("4 (f32 lane)", phase_f32_lane, psi2)
    training = timed("5", phase_training, psi2, psi_stats)
    timed("5 (f32 lane)", phase_f32_lane_trained, psi2)
    timed("6", phase_golden)
    config2 = timed("7", phase_configs_2_3, psi2, psi_stats)
    config4 = timed("8", phase_config4, psi2, psi_stats, card)
    uncertain = timed("8 (svgp uncertain)", phase_svgp_uncertain, psi2, psi_stats)
    t9 = time.perf_counter()
    c5_potential = timed("9a (config 5 potential)", phase_config5_potential, psi2, psi_stats, root, card)
    timed("9b (config 5 NUTS twin)", phase_config5_nuts, psi2, psi_stats, root, card)
    c5_sample = timed("9c (config 5 sample_nuts)", phase_config5_sample_nuts, psi2, psi_stats, root, card)
    timed("9d (config 5 SMC twin)", phase_config5_smc, card)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s wall")
    t10 = time.perf_counter()
    tempered_ll, _ = timed("10a (tempered log-likelihood)", phase_tempered_loglik, psi2, psi_stats, root, card)
    tempered = timed("10b (sample_tempered)", phase_tempered_smc, psi2, psi_stats, root, card)
    timed("10c (examples)", phase_examples, psi2, psi_stats, card)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s wall")

    def row(name, src, replaces, tpu_kernel, launches, by_path, rows):
        main_row = rows[0]  # (512, 100, 20): config 1's hidden layer
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_kernel": tpu_kernel,
            "launches": launches, "launches_by_path": by_path,
            "shape": [main_row["T"], main_row["M"], main_row["Q"]],
            "max_abs_err": main_row["max_abs_err"], "max_rel_err": main_row["max_rel_err"],
            "ms": main_row["ms"], "device_ms": main_row["device_ms"],
            "launches_per_call": main_row["launches_per_call"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "shapes": rows, "ptxas": ptxas[name], "card": card,
        }

    print(json.dumps({"kernels": [
        row("psi2_fwd", "rgp_tpu_torch/csrc/psi2_fwd.cu", "rgp_tpu/ops/pallas/psi2.py:147",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_kernel (_psi2_pallas_raw)", training["k1"],
            {"training": training["k1"], "serving": serving, "config2_training": config2["k1"],
             "config4_training": config4["k1"], "svgp_uncertain_elbo": uncertain["k1"],
             "config5_potential_auto": c5_potential["k1"], "config5_sample_nuts_4chains": c5_sample["k1"],
             "tempered_loglik_auto": tempered_ll["k1"], "tempered_smc": tempered["k1"]}, k1_rows),
        row("psi2_bwd", "rgp_tpu_torch/csrc/psi2_bwd.cu", "rgp_tpu/ops/pallas/psi2.py:274",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_bwd_kernel (_psi2_bwd_raw)", training["k2"],
            {"training": training["k2"], "serving": 0, "config2_training": config2["k2"],
             "config4_training": config4["k2"], "svgp_uncertain_elbo": uncertain["k2"],
             "config5_potential_auto": c5_potential["k2"], "config5_sample_nuts_4chains": c5_sample["k2"],
             "tempered_loglik_auto": tempered_ll["k2"], "tempered_smc": tempered["k2"]}, k2_rows),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
