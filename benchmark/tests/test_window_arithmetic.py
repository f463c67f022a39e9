"""The whole-window rate, the p90 and the trace arithmetic."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import drive, run, trace
from benchmark.tests.conftest import small_cell


def _ctx(kind, **kw):
    base = dict(kind=kind, setup_s=7.5, trace=None, units=0, per_unit_ops=0.0, fp32_ops_per_s=67e12)
    base.update(kw)
    return SimpleNamespace(**base)


def test_rollout_rate_counts_requests_width_and_horizon():
    win = drive.Window(30.0, 120 * 1024 * 16, 120, [0.25] * 120, 0, {}, None, 0)
    assert run.load_reader("rollout_steps_per_s")(_ctx("rollout", window=win)) == pytest.approx(
        120 * 1024 * 16 / 30.0)


@pytest.mark.parametrize("lat,want", [
    (list(range(1, 11)), 9),  # nearest rank: the 9th of 10
    (list(range(1, 101)), 90),
    (list(range(100, 0, -1)), 90),  # order does not matter
    ([5.0], 5.0),
    (list(range(1, 12)), 10),  # ceil(9.9) = 10th of 11
])
def test_p90_is_nearest_rank_over_all_requests(lat, want):
    read = run.load_reader("rollout_p90_ms.host")
    win = drive.Window(1.0, 0, len(lat), [x / 1e3 for x in lat], 0, {}, None, 0)
    assert read(_ctx("rollout", window=win)) == pytest.approx(want)


def test_busy_time_is_the_union_of_device_intervals():
    busy, gaps = trace._union([(0, 10), (5, 12), (20, 30), (25, 26), (40, 41)])
    assert busy == 12 + 10 + 1
    assert gaps == [(12, 20), (30, 40)]


def _trace(ops, busy_s, window_s):
    return trace.Trace(ops, busy_s, window_s, [], [])


def test_trace_readers():
    ops = [("void psi2_fwd_kernel<20>(FwdArgs)", 0, 2_000_000), ("potrf_kernel", 0, 1_000_000),
           ("elementwise_kernel", 0, 4_000_000), ("gemv", 0, 1_000_000)]
    ctx = _ctx("rollout", trace=_trace(ops, 0.01, 0.04), units=10, per_unit_ops=1e9)
    assert run.load_reader("launches_per_step.rollout")(ctx) == pytest.approx(0.4)
    assert run.load_reader("idle_share.rollout")(ctx) == pytest.approx(75.0)
    assert run.load_reader("mfu.rollout")(ctx) == pytest.approx(100 * 1e10 / (0.04 * 67e12))


def test_readers_find_nothing_without_a_trace():
    for name in ("launches_per_step.rollout", "idle_share.rollout", "mfu.rollout"):
        assert run.load_reader(name)(_ctx("rollout")) is None
    assert run.load_reader("launches_per_step.rollout")(_ctx("rollout", trace=_trace([], 0.0, 1.0), units=3)) is None


def test_the_trace_follows_the_window_and_p90_leaves_it_out(cpu):
    cell = small_cell("rgp1-rollout-w16384")
    cell.config.pop("served_params", None)
    from benchmark import inputs

    rec = inputs.record(cell.config, torch.float32, cpu, T=cell.config["T"])
    setup, window = drive.DRIVERS["rollout"]
    st = setup(cell.config, cell.traffic, rec, 5, torch.float32)
    win = window(st, cell.config, cell.traffic, 0.2, True)
    assert win.trace is not None and len(win.latencies) == win.steps - cell.traffic["trace_requests"]
    assert win.trace_units == cell.traffic["trace_requests"] * cell.traffic["horizon"]
    win = window(st, cell.config, cell.traffic, 0.2, False)
    assert len(win.latencies) == win.steps
