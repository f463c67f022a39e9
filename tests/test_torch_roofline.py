"""rgp_tpu_torch.bench.roofline against rgp_tpu.bench.roofline on the CPU.

* ``report`` on one ceilings dict gives the JAX ``report``'s columns for
  every op that is not a Psi2 row, and its own bound against the published
  peaks;
* ``measure_ops`` at (T, M, Q) = (64, 16, 4) has the JAX op set, the Psi2
  rows mapped (``psi2_sum_xla`` -> ``psi2_sum_plain``, the two
  ``psi2_fwd_bwd_xla*`` -> ``psi2_fwd_bwd_plain``; the kernels' rows, like
  the JAX module's Pallas rows, run on the card only), and the JAX work
  counts of the other ops;
* the plain and kernel rows of one function share one work count, and
  ``k1_bound_ms`` / ``k2_bound_ms`` (moved here from ``chip_smoke.py``) give
  PERF.md's Bound column at its 12 shapes;
* the exp probe's plain chain, and on the card the probe against it.
"""

import math

import numpy as np
import pytest
import torch

from rgp_tpu.bench import roofline as jroof
from rgp_tpu_torch.bench import roofline as troof
from rgp_tpu_torch.ops.cuda import exp_probe

SHAPE = (64, 16, 4)
PSI2_MAP = {"psi2_sum_xla": "psi2_sum_plain", "psi2_fwd_bwd_xla": "psi2_fwd_bwd_plain",
            "psi2_fwd_bwd_xla_scan128": "psi2_fwd_bwd_plain"}
JAX_COLUMNS = ("util_mxu", "util_vpu_exp", "util_hbm", "binding_resource", "roofline_fraction")
CEILINGS = {"matmul_f32_highest_flops": 5.1e13, "hbm_bandwidth_bytes": 3.0e12, "exp_per_sec": 2.0e12}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _once(fn, *args, **kw):
    """A ``_timeit`` that calls ``fn`` once and reports 1 ms."""
    fn(*args)
    return 1e-3


@pytest.fixture(scope="module")
def both_ops():
    """(JAX measure_ops, port measure_ops) at SHAPE, each op run once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jroof, "_timeit", lambda fn, *args, **kw: _once(fn, *args))
    mp.setattr(troof, "_timeit", lambda fn, dev, **kw: (_once(fn), 1))
    try:
        yield jroof.measure_ops(*SHAPE), troof.measure_ops(*SHAPE, device="cpu")
    finally:
        mp.undo()


def test_measure_ops_has_the_jax_op_set(both_ops):
    ref, ours = both_ops
    assert {PSI2_MAP.get(o["op"], o["op"]) for o in ref} == {o["op"] for o in ours}
    assert len(ours) == len({o["op"] for o in ours})


def test_non_psi2_work_counts_are_the_jax_ones(both_ops):
    ref, ours = both_ops
    by_name = {o["op"]: o for o in ours}
    for o in ref:
        if o["op"] in PSI2_MAP:
            continue
        for k in ("mxu_flops", "exps", "bytes_min"):
            assert by_name[o["op"]][k] == pytest.approx(o[k], rel=1e-12), (o["op"], k)


def test_psi2_rows_share_one_work_count(both_ops):
    _, ours = both_ops
    T, M, Q = SHAPE
    by_name = {o["op"]: o for o in ours}
    f1, e1, b1 = troof.k1_work(T, M, Q)
    f2, e2, b2 = troof.k2_work(T, M, Q)
    s, fb = by_name["psi2_sum_plain"], by_name["psi2_fwd_bwd_plain"]
    assert (s["mxu_flops"], s["exps"], s["bytes_min"]) == (f1, e1, b1)
    assert (fb["mxu_flops"], fb["exps"], fb["bytes_min"]) == (f1 + f2, e1 + e2, b1 + b2)
    rows = {r["op"]: r for r in troof.report(CEILINGS, ours)["ops"]}
    assert rows["psi2_sum_plain"]["bound_ms"] == troof.k1_bound_ms(T, M, Q)[0]
    assert rows["psi2_fwd_bwd_plain"]["bound_ms"] == troof.bound_ms(f1 + e1 + f2 + e2, b1 + b2)[0]
    # where both kernels are bound by operations (the production shape), the
    # forward-and-backward bound is the sum of the two kernels' bounds
    big = (2048, 256, 32)
    (k1_ms, k1_by), (k2_ms, k2_by) = troof.k1_bound_ms(*big), troof.k2_bound_ms(*big)
    f1, e1, b1 = troof.k1_work(*big)
    f2, e2, b2 = troof.k2_work(*big)
    assert k1_by == k2_by == "operations"
    assert troof.bound_ms(f1 + e1 + f2 + e2, b1 + b2)[0] == pytest.approx(k1_ms + k2_ms, rel=1e-12)
    # on the CPU no kernel launches; the plain sums count theirs
    assert all(o["k1_per_call"] == o["k2_per_call"] == 0.0 for o in ours)
    assert by_name["collapsed_bound_fwd_bwd"]["plain_psi2_per_call"] == 1.0


def test_report_gives_the_jax_columns(both_ops):
    _, ours = both_ops
    rng = np.random.default_rng(0)
    ops = [{**o, "ms": float(rng.uniform(0.01, 5.0))} for o in ours]
    ref = {r["op"]: r for r in jroof.report(CEILINGS, [o for o in ops if not o["op"].startswith("psi2")])["ops"]}
    rep = troof.report(CEILINGS, ops)
    assert rep["ceilings"] == CEILINGS
    for row in rep["ops"]:
        if row["op"] in ref:
            for k in JAX_COLUMNS:
                assert row[k] == ref[row["op"]][k], (row["op"], k)
        b_ms, b_by = troof.bound_ms(row["mxu_flops"] + row["exps"], row["bytes_min"])
        assert (row["bound_ms"], row["bound_by"]) == (b_ms, b_by)
        assert row["peak_share"] == pytest.approx(b_ms / row["ms"], rel=1e-15)
    assert set(ref) == {r["op"] for r in rep["ops"]} - {"psi2_sum_plain", "psi2_fwd_bwd_plain"}


# PERF.md's kernel table: (T, M, Q) -> (K1 bound, K2 bound), ms, as printed
PERF_BOUNDS = {
    (512, 100, 20): ("0.00181", "0.00508"), (512, 100, 1): ("0.00035", "0.00066"),
    (65, 130, 5): ("0.00014", "0.00034"), (2048, 256, 32): ("0.0714", "0.2046"),
    (250, 100, 16): ("0.00073", "0.00203"), (250, 100, 12): ("0.00058", "0.00157"),
}


@pytest.mark.parametrize("shape", sorted(PERF_BOUNDS))
@pytest.mark.parametrize("kernel", [0, 1], ids=["k1", "k2"])
def test_bounds_are_perf_mds(shape, kernel):
    printed = PERF_BOUNDS[shape][kernel]
    ms, by = (troof.k1_bound_ms, troof.k2_bound_ms)[kernel](*shape)
    decimals = len(printed.split(".")[1])
    assert by == "operations"
    assert abs(ms - float(printed)) <= 0.5 * 10.0 ** -decimals + 1e-15


def test_exp_chain_on_the_cpu_is_the_plain_chain():
    x = torch.rand(1000, dtype=torch.float32) + 0.5
    n = exp_probe.launches
    y = exp_probe.exp_chain(x, 64)
    assert exp_probe.launches == n
    ref = x.double()
    for _ in range(64):
        ref = torch.exp(ref * 1e-6)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-6)
    assert torch.equal(y, exp_probe.exp_chain_plain(x, 64))
    # the chain stays near 1: exp(x * 1e-6) moves it by ~1e-6 a link
    assert float((y - 1.0).abs().max()) < 1e-5


def test_capture_trace_on_the_cpu():
    planes = troof.capture_trace(None, *SHAPE, device="cpu", top=5)
    assert len(planes) == 1 and planes[0]["plane"] == "cpu"
    rows = planes[0]["top_ops"]
    assert len(rows) == 5 and sorted(rows[0]) == ["count", "frac", "ms", "op"]
    assert all(r["ms"] >= s["ms"] for r, s in zip(rows, rows[1:]))
    assert math.isclose(sum(r["frac"] for r in rows), sum(r["ms"] for r in rows) / planes[0]["total_ms"])


@pytest.mark.cuda
def test_exp_probe_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.rand(1 << 20, device="cuda") + 0.5
    n = exp_probe.launches
    y = exp_probe.exp_chain(x, 64)
    torch.cuda.synchronize()
    assert exp_probe.launches == n + 1
    torch.testing.assert_close(y, exp_probe.exp_chain_plain(x, 64), rtol=1e-5, atol=0.0)
    with pytest.raises(TypeError):
        exp_probe.exp_chain(x.double(), 4)
