"""Roofline attribution of the hot ops on the card (the twin of
``rgp_tpu/bench/roofline.py``).

1. :func:`calibrate` measures this card's ceilings:
   - FP32 ``torch.matmul`` at n = 4096 with TF32 off. The port pins TF32
     off (``linalg``), so this is the counterpart of the JAX module's
     ``HIGHEST`` row; its "f32 default precision" row (bf16 passes on the
     TPU's matrix unit) has no counterpart here;
   - bf16 ``torch.matmul``;
   - the memory stream: a triad written as one kernel, ``torch.add(y, x,
     alpha=...)`` (two reads and one write an element; ``x * a + y`` would
     be two kernels), on 128 MiB arrays;
   - the exp rate: the CUDA probe ``csrc/exp_probe.cu``, 64 chained
     ``expf`` in registers a thread (64 eager ``torch.exp`` calls would be 64
     memory-bound kernels, the 16x under-statement the JAX module warns of).
2. :func:`measure_ops` times each hot op of the RGP training step at the
   production shape (2048, 256, 32) with CUDA events: many calls, one
   synchronize. The Psi2 time sum and its VJP run as two rows each, the
   plain PyTorch version and the kernels (``psi2_sum_plain`` /
   ``psi2_sum_k1``, ``psi2_fwd_bwd_plain`` / ``psi2_fwd_bwd_k1k2``, in place
   of the JAX ``psi2_sum_xla`` / ``_pallas`` and ``psi2_fwd_bwd_xla*`` /
   ``_pallas``), and the rows that compute one function share one work
   count, whatever implements it. The other rows keep the JAX work models.
3. :func:`report` attributes each row's work two ways: against the measured
   ceilings (the JAX columns ``util_mxu``, ``util_vpu_exp``, ``util_hbm``,
   ``binding_resource``, ``roofline_fraction``), and against the published
   H100 SXM peaks, 67 TFLOP/s FP32 outside the tensor cores (an exp counts
   as one operation) and 3.35 TB/s: ``bound_ms`` is the larger of the
   operations over the one and the bytes over the other, ``bound_by`` which,
   and ``peak_share`` the bound over the measured time. The card's name and
   power limit (``nvidia-smi``) go beside them: a card set below 700 W runs
   slower under load.
4. :func:`capture_trace` profiles the production step (the whitened bound
   with its basis computed once, forward and backward) and returns its top
   device ops.

This module is the one place that counts the work of the Psi2 time sum
(:func:`k1_work`, K1's function) and of its VJP (:func:`k2_work`, K2's);
``chip_smoke.py`` takes its bounds from :func:`k1_bound_ms` and
:func:`k2_bound_ms`.

    python -m rgp_tpu_torch.bench.roofline [--out FILE] [--T 2048 --M 256 --Q 32] [--trace-dir DIR]

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from .sampling import _card

__all__ = ["FP32_OPS_PER_S", "HBM_BYTES_PER_S", "k1_work", "k2_work", "bound_ms", "k1_bound_ms", "k2_bound_ms",
           "calibrate", "measure_ops", "report", "capture_trace", "main"]

FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores, at 700 W
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3
_F32 = 4  # bytes


# ----------------------------------------------------------------- work counts


def k1_work(T, M, Q):
    """(FP32 operations, exps, bytes) of the Psi2 time sum from (base, E, D1,
    w, Z): per element (t, m, n) with m <= n (the output is symmetric, so T
    M(M+1)/2 elements are all the function needs) 2Q+6 operations and one
    exp; each input read once and the (M, M) output written once."""
    elems = T * M * (M + 1) // 2
    nbytes = _F32 * (T + T * M + M * M + T * Q + M * Q + M * M)
    return elems * (2 * Q + 6), elems, nbytes


def k2_work(T, M, Q):
    """(FP32 operations, exps, bytes) of the Psi2 time sum's VJP (dbase, dE,
    dD1, dw, dzC) from the inputs, the cotangent g and the output. PGs = P (g
    + g^T) is symmetric in (m, n), so per timestep the function needs M(M-1)/2
    pairs m < n at 6Q+10 operations and one exp (C once, the exp's argument
    and the product with Gs once, S and dE for both rows) and M diagonal
    elements at 4Q+8 and one exp; then 2Q per (t, m) each for dw and dzC,
    and g + g^T and -out g per (m, n). Inputs (base, E, D1, w, Z, g, out)
    read once, outputs written once."""
    pairs, diag = M * (M - 1) // 2, M
    exps = T * (pairs + diag)
    ops = T * (pairs * (6 * Q + 10) + diag * (4 * Q + 8)) + 4 * T * M * Q + 2 * M * M
    nbytes = _F32 * (2 * T + 2 * T * M + 4 * M * M + 2 * T * Q + 2 * M * Q)
    return ops, exps, nbytes


def bound_ms(ops, nbytes):
    """(least ms, "operations" or "bytes"): the larger of ``ops`` (an exp
    counts as one) at the FP32 peak and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(T, M, Q):
    """Least time for K1's function (:func:`k1_work`) on an H100 SXM."""
    flops, exps, nbytes = k1_work(T, M, Q)
    return bound_ms(flops + exps, nbytes)


def k2_bound_ms(T, M, Q):
    """Least time for K2's function (:func:`k2_work`) on an H100 SXM."""
    ops, exps, nbytes = k2_work(T, M, Q)
    return bound_ms(ops + exps, nbytes)


# ----------------------------------------------------------------- timing


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, dev, iters: int = 50, warmup: int = 2):
    """(seconds a call, calls made): ``warmup`` calls, one timed call to size
    the run (at most ~5 s of calls, at least 5), then that many back-to-back
    calls (:func:`rgp_tpu_torch.bench.psi2_times.back_to_back_ms`)."""
    from .psi2_times import back_to_back_ms

    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    t1 = time.perf_counter() - t0
    n = max(5, min(iters, int(5.0 / max(t1, 1e-4))))
    return back_to_back_ms(fn, dev, n) / 1e3, warmup + 1 + n


# ----------------------------------------------------------------- ceilings


def calibrate(n: int = 4096, device=None) -> dict:
    """Measured ceilings of this card, with the published peaks beside
    them."""
    from .. import linalg  # noqa: F401  (pins TF32 off)
    from ..ops.cuda.exp_probe import exp_chain

    dev = resolve_device(device)
    print("  [roofline] calibrating ceilings...", flush=True)
    gen = torch.Generator(dev).manual_seed(0)
    a32 = torch.randn((n, n), generator=gen, device=dev)
    b32 = torch.randn((n, n), generator=gen, device=dev)
    a16, b16 = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    flops = 2.0 * n * n * n
    t32, _ = _timeit(lambda: torch.matmul(a32, b32), dev)
    print(f"  [roofline] matmul f32 (TF32 off): {flops / t32 / 1e12:.1f} TFLOP/s", flush=True)
    t16, _ = _timeit(lambda: torch.matmul(a16, b16), dev)
    print(f"  [roofline] matmul bf16: {flops / t16 / 1e12:.1f} TFLOP/s", flush=True)

    # memory stream: out = y + 1.0001 x, one kernel, 2 reads + 1 write an element
    m = 128 * 1024 * 1024 // 4  # 32M float32 elements, 128 MiB an array
    x = torch.ones((m,), device=dev)
    y = torch.ones((m,), device=dev)
    t_bw, _ = _timeit(lambda: torch.add(y, x, alpha=1.0001), dev, iters=10)
    bytes_moved = 3.0 * _F32 * m

    # exp rate: K chained exps in registers a thread (csrc/exp_probe.cu), so
    # the two passes over memory are amortized over K exps
    K = 64
    me = 8 * 1024 * 1024
    t_exp, _ = _timeit(lambda: exp_chain(x[:me], K), dev, iters=10)

    name, card = _card(dev)
    return {
        "device_kind": name,
        "backend": dev.type,
        "card": card,
        "matmul_f32_highest_flops": flops / t32,
        "matmul_bf16_flops": flops / t16,
        "hbm_bandwidth_bytes": bytes_moved / t_bw,
        "exp_per_sec": me * K / t_exp,
        "published_fp32_ops_per_sec": FP32_OPS_PER_S,
        "published_hbm_bytes_per_sec": HBM_BYTES_PER_S,
    }


# ------------------------------------------------------------------ hot ops


def _rbf_params(Q, dtype, dev):
    from ..params import np_positive_inv

    return {"log_var": np_positive_inv(1.0, dtype, dev), "log_ls": np_positive_inv(np.full(Q, 1.2), dtype, dev)}


def _inputs(T, M, Q, dev, seed=1):
    """(p, Z, mu, s, Y, log_noise) float32 at (T, M, Q), from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    mu = t(rng.standard_normal((T, Q)))
    s = t(0.05 * rng.uniform(size=(T, Q)) + 0.01)
    Z = t(rng.standard_normal((M, Q)))
    Y = t(rng.standard_normal((T, 1)))
    return _rbf_params(Q, torch.float32, dev), Z, mu, s, Y, torch.zeros((), device=dev)


def measure_ops(T: int = 2048, M: int = 256, Q: int = 32, device=None) -> list[dict]:
    """Time each hot op class at (T, M, Q) and attribute its work.

    Work models (per call; ``mxu_flops`` are FP32 operations outside the
    exp, the JAX module's name kept):
    - psi1: 6 T M Q flops, T M exps; read mu, s, Z, write (T, M).
    - psi2_sum_plain / psi2_sum_k1: the Psi2 time sum from (base, E, D1, w,
      Z), :func:`k1_work`. The plain PyTorch version and K1 compute the same
      function; K1's row runs one K1 launch a call.
    - psi2_fwd_bwd_plain / psi2_fwd_bwd_k1k2: the sum and its VJP for the
      cotangent of ``sum(out)``, :func:`k1_work` plus :func:`k2_work`; the
      kernels' row is the autograd Function, one K1 and one K2 launch a call.
    - cholesky(M): M^3/3 flops. triangular_solve (M,M) x (M,T): T M^2.
    - eigh(M): ~9 M^3.
    - collapsed_bound_fwd_bwd: the whitened collapsed bound, value and
      gradients, with the per-call eigh and floor ladder;
      ..._amortized_whitening: the production step, the basis computed once.
    The K1/K2 rows run on the card only (as the JAX module's Pallas rows ran
    on the TPU only). Every row records the K1/K2 launches and plain Psi2
    sums a call."""
    from ..inference.collapsed_vi import collapsed_bound, whitening_basis
    from ..kernels import RBF
    from ..ops import psi_stats as ps
    from ..ops.cuda import psi2
    from ..params import positive

    dev = resolve_device(device)
    p, Z, mu, s, Y, log_noise = _inputs(T, M, Q, dev)
    kern = RBF(input_dim=Q)
    ops: list[dict] = []

    def add(name, fn, mxu_flops=0.0, exps=0.0, bytes_min=0.0, note=""):
        n1, n2, n0 = psi2.launches, psi2.bwd_launches, ps.plain_psi2_calls
        sec, calls = _timeit(fn, dev)
        print(f"  [roofline] {name}: {sec * 1e3:.3f} ms", flush=True)
        ops.append({
            "op": name, "ms": sec * 1e3, "mxu_flops": mxu_flops, "exps": exps, "bytes_min": bytes_min,
            "note": note, "k1_per_call": (psi2.launches - n1) / calls,
            "k2_per_call": (psi2.bwd_launches - n2) / calls, "plain_psi2_per_call": (ps.plain_psi2_calls - n0) / calls,
        })

    B = float(_F32)
    add("psi1", lambda: ps._rbf_psi1(p, Z, mu, s), mxu_flops=6.0 * T * M * Q, exps=1.0 * T * M,
        bytes_min=B * (2 * T * Q + M * Q + T * M))

    pre = [x.to(torch.float32).contiguous() for x in (*psi2.rbf_psi2_precompute(p, Z, mu, s), Z)]
    f1, e1, b1 = k1_work(T, M, Q)
    f2, e2, b2 = k2_work(T, M, Q)
    add("psi2_sum_plain", lambda: psi2.psi2_time_sum_plain(*pre), mxu_flops=f1, exps=e1, bytes_min=b1,
        note="plain PyTorch: per T range, the (t, M, M) probabilities materialized")
    if dev.type == "cuda":
        add("psi2_sum_k1", lambda: psi2.psi2_time_sum(*pre), mxu_flops=f1, exps=e1, bytes_min=b1,
            note="K1, csrc/psi2_fwd.cu: one launch")
    G = torch.ones((M, M), dtype=torch.float32, device=dev)

    def fwd_bwd_plain():
        out = psi2.psi2_time_sum_plain(*pre)
        return psi2.psi2_time_sum_bwd_plain(*pre, G, out)

    add("psi2_fwd_bwd_plain", fwd_bwd_plain, mxu_flops=f1 + f2, exps=e1 + e2, bytes_min=b1 + b2,
        note="plain PyTorch forward, then the plain VJP")
    if dev.type == "cuda":
        req = [x.detach().requires_grad_() for x in pre]

        def fwd_bwd_kernels():
            return torch.autograd.grad(psi2.RBFPsi2Sum.apply(*req), req, G)

        add("psi2_fwd_bwd_k1k2", fwd_bwd_kernels, mxu_flops=f1 + f2, exps=e1 + e2, bytes_min=b1 + b2,
            note="the autograd Function: one K1 and one K2 launch")

    with torch.no_grad():
        Kmm = kern.K(p, Z, Z) + 1e-4 * torch.eye(M, dtype=torch.float32, device=dev)
    add("cholesky_M", lambda: torch.linalg.cholesky(Kmm), mxu_flops=M**3 / 3.0, bytes_min=B * 2 * M * M,
        note="sequential panel factorization; latency-bound at M=256")
    L = torch.linalg.cholesky(Kmm)
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal((M, T)), dtype=torch.float32, device=dev)
    add("triangular_solve_M_T", lambda: torch.linalg.solve_triangular(L, rhs, upper=False),
        mxu_flops=1.0 * T * M * M, bytes_min=B * (M * M + 2 * M * T))
    add("eigh_M", lambda: torch.linalg.eigh(Kmm), mxu_flops=9.0 * M**3, bytes_min=B * 3 * M * M,
        note="whitening basis; amortized over train steps (aux_fn)")

    leaves = [x.detach().clone().requires_grad_() for x in (p["log_var"], p["log_ls"], Z, log_noise, mu, s)]

    def bound(W=None):
        lv, ll, z, ln, m_, s_ = leaves
        kp = {"log_var": lv, "log_ls": ll}
        stats = ps.psi_statistics(kern, kp, z, m_, s_, block=None)
        return collapsed_bound(kern, kp, z, ln, stats, Y, W=W)

    def value_and_grad(W=None):
        val = bound(W)
        return val, torch.autograd.grad(val, leaves)

    bound_flops = 3.0 * 2.0 * T * M * M * Q + 2.0 * T * M * M
    bound_exps = 2.0 * T * M * M + 3.0 * T * M
    bound_bytes = B * (2 * (2 * T * Q + M * Q + T * M) + 4 * M * M)
    add("collapsed_bound_fwd_bwd", value_and_grad, mxu_flops=bound_flops + 12.0 * M**3, exps=bound_exps,
        bytes_min=bound_bytes,
        note="psi stats + whitening + solves + assembly, fwd+bwd; includes a PER-CALL eigh + floor-ladder "
             "that production amortizes")
    with torch.no_grad():
        stats = ps.psi_statistics(kern, p, Z, mu, s, block=None)
        wh = whitening_basis(kern.K(p, Z, Z), stats.psi2, 1.0 / positive(log_noise))
    add("collapsed_bound_fwd_bwd_amortized_whitening", lambda: value_and_grad(wh),
        mxu_flops=bound_flops + 3.0 * M**3, exps=bound_exps, bytes_min=bound_bytes,
        note="production step (whitening basis precomputed, refreshed every 100 train steps): psi stats + "
             "solves + assembly fwd+bwd only")
    return ops


def report(ceilings: dict, ops: list[dict]) -> dict:
    """Each row's utilization of the measured ceilings and its binding
    resource (the JAX columns), and its bound against the published peaks:
    ``bound_ms``, ``bound_by`` and ``peak_share`` (bound over time)."""
    mxu = ceilings["matmul_f32_highest_flops"]
    bw = ceilings["hbm_bandwidth_bytes"]
    eps = ceilings["exp_per_sec"]
    rows = []
    for o in ops:
        sec = o["ms"] / 1e3
        u_mxu = (o["mxu_flops"] / sec) / mxu if o["mxu_flops"] else 0.0
        u_exp = (o["exps"] / sec) / eps if o["exps"] else 0.0
        u_bw = (o["bytes_min"] / sec) / bw if o["bytes_min"] else 0.0
        binding = max(("mxu", u_mxu), ("vpu_exp", u_exp), ("hbm", u_bw), key=lambda kv: kv[1])
        b_ms, b_by = bound_ms(o["mxu_flops"] + o["exps"], o["bytes_min"])
        rows.append({
            **o,
            "util_mxu": round(u_mxu, 4),
            "util_vpu_exp": round(u_exp, 4),
            "util_hbm": round(u_bw, 4),
            "binding_resource": binding[0],
            "roofline_fraction": round(binding[1], 4),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "peak_share": b_ms / o["ms"],
        })
    return {"ceilings": ceilings, "ops": rows}


def _op_table(prof, cuda: bool, top: int):
    """[{"op", "ms", "count", "frac"}] of a trace's top ops by time: the
    card's kernels and copies, or on the CPU the ops' self time."""
    if cuda:
        from .psi2_times import card_events

        by_name = {k: (us / 1e3, c) for k, (us, c) in card_events(prof).items()}
    else:
        by_name = {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0}
    total = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:top]
    return total, sum(c for _, c in by_name.values()), [
        {"op": k[:120], "ms": ms, "count": c, "frac": ms / total if total else 0.0} for k, (ms, c) in rows]


def capture_trace(log_dir: str | None = None, T: int = 2048, M: int = 256, Q: int = 32, device=None,
                  top: int = 20):
    """torch.profiler over 10 calls of the production step (the whitened
    bound with its basis computed once, value and gradients) at (T, M, Q):
    the top device ops by time. With ``log_dir`` the trace is also written
    there as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    from ..inference.collapsed_vi import collapsed_bound, whitening_basis
    from ..kernels import RBF
    from ..ops import psi_stats as ps
    from ..params import positive

    dev = resolve_device(device)
    p, Z, mu, s, Y, ln = _inputs(T, M, Q, dev)
    kern = RBF(input_dim=Q)
    with torch.no_grad():
        stats = ps.psi_statistics(kern, p, Z, mu, s, block=None)
        wh = whitening_basis(kern.K(p, Z, Z), stats.psi2, 1.0 / positive(ln))
    leaves = [x.detach().clone().requires_grad_() for x in (p["log_var"], p["log_ls"], Z, mu, s)]

    def step():
        lv, ll, z, m_, s_ = leaves
        kp = {"log_var": lv, "log_ls": ll}
        val = collapsed_bound(kern, kp, z, ln, ps.psi_statistics(kern, kp, z, m_, s_, block=None), Y, W=wh)
        return val, torch.autograd.grad(val, leaves)

    step()
    _sync(dev)
    cuda = dev.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            step()
        _sync(dev)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "roofline_trace.json"))
    total, n_events, rows = _op_table(prof, cuda, top)
    return [{"plane": _card(dev)[0], "total_ms": total, "n_events": n_events, "top_ops": rows}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--M", type=int, default=256)
    ap.add_argument("--Q", type=int, default=32)
    ap.add_argument("--trace-dir", default=None, help="also capture a profiler trace")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    ceilings = calibrate(device=args.device)
    ops = measure_ops(args.T, args.M, args.Q, device=args.device)
    rep = report(ceilings, ops)
    rep["shape"] = {"T": args.T, "M": args.M, "Q": args.Q}
    if args.trace_dir:
        rep["trace_op_stats"] = capture_trace(args.trace_dir, args.T, args.M, args.Q, device=args.device)
        rep["trace_dir"] = args.trace_dir

    print(json.dumps({"ceilings": rep["ceilings"], "shape": rep["shape"]}, indent=2))
    print(f"{'op':<46}{'ms':>10}{'mxu':>8}{'exp':>8}{'hbm':>8}  binding   bound_ms  of peak")
    for r in rep["ops"]:
        print(f"{r['op']:<46}{r['ms']:>10.4f}{r['util_mxu']:>8.2%}{r['util_vpu_exp']:>8.2%}"
              f"{r['util_hbm']:>8.2%}  {r['binding_resource']:<8}{r['bound_ms']:>10.5f}  "
              f"{r['peak_share']:.2%} ({r['bound_by']})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rep, fh, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
