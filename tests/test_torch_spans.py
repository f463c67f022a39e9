"""The serving path's profiler spans on the CPU, and the benchmark's reading
of them (``benchmark/spans.py``).

The three served configurations (config 1's one-layer RGP, config 2's
two-layer RGP with back-constraint MLPs, config 1 with an RBF-ARD +
Linear-ARD hidden kernel), cut to a short record and 12 inducing points,
float32, a batched freerun of 8 candidates over the benchmark's 16-step
horizon: a request holds one ``rgp.posteriors`` span (its ``psi.stats``
spans inside, one a layer) and one ``rgp.freerun.step`` span a step (its
``psi.per_t`` spans inside, one a layer), the additive kernel's cross term
one ``psi.cross`` span inside its layer's ``psi.stats`` and each of its
``psi.per_t``, and the outputs are the same bits with the profiler on and
off. The attribution of device operations, host waits and idle time is
checked on hand-made events, since the CPU has no device events.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import drive, inputs, run, spans
from rgp_tpu_torch.bench import serving

WIDTH, REQUESTS = 8, 2


SUM_CELL = "rgp1lin-rollout-w16384"  # the hidden kernel RBF-ARD + Linear-ARD


@pytest.fixture(scope="module", params=["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024", SUM_CELL])
def served(request):
    cell = run.load_cell(request.param)
    cfg = dict(cell.config, T=64, num_inducing=12)
    cfg.pop("served_params", None)  # fitted at the full size
    cpu = torch.device("cpu")
    rec = inputs.record(cfg, torch.float32, cpu, T=cfg["T"])
    gen = inputs.generator(2**33 + 5, cpu)
    params = inputs.served_params(cfg, rec, gen, torch.float32)
    horizon = cell.traffic["horizon"]
    Us = [inputs.candidates(cfg, rec, WIDTH, horizon, gen) for _ in range(REQUESTS)]
    return drive.program_cfg(cfg), params, rec, Us, horizon, request.param


def _requests(pc, params, rec, Us):
    outs = []
    for U in Us:
        with record_function(spans.REQUEST):
            outs.append(serving.batched_freerun(pc, params, rec.Y, rec.U, U))
    return outs


def _traced(served):
    pc, params, rec, Us, *_ = served
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()  # as the benchmark's tracer starts it
    try:
        outs = _requests(pc, params, rec, Us)
    finally:
        prof.stop()
    return outs, spans.read(spans.events_of(prof))


def test_a_request_holds_one_posteriors_span_and_a_step_span_a_step(served):
    pc, _, _, _, horizon, _ = served
    _, r = _traced(served)
    reqs = r.nesting.named(spans.REQUEST)
    assert len(reqs) == REQUESTS
    layers = pc.n_hidden + 1
    for lo, hi in reqs:
        def inside(name):
            return [(s, e) for s, e in r.nesting.named(name) if lo <= s and e <= hi]

        assert len(inside(spans.POSTERIORS)) == 1
        assert len(inside(spans.STEP)) == horizon
        assert len(inside("psi.per_t")) == layers * horizon
        assert len(inside("psi.stats")) == layers
    for s, e in r.nesting.named("psi.per_t"):
        assert spans.STEP in r.holding(s) and spans.STEP in r.holding(e)
    for s, e in r.nesting.named("psi.stats"):
        assert spans.POSTERIORS in r.holding(s) and spans.POSTERIORS in r.holding(e)
    assert len(r.nesting.named(spans.STEP)) == REQUESTS * horizon


def test_an_additive_kernels_cross_term_is_one_span_in_its_layers_psi_terms(served):
    """The Sum configuration's hidden layer: one ``psi.cross`` inside its
    ``psi.stats`` in the posteriors and inside its ``psi.per_t`` in each
    step; the output layer (RBF) and the RBF-only configurations hold none,
    and the reader of the span's device time finds nothing there."""
    _, _, _, _, horizon, name = served
    _, r = _traced(served)
    crosses = r.nesting.named("psi.cross")
    read = run.load_reader("psi_cross_ms_per_step.rollout")
    ctx = _ctx(r, units=len(r.nesting.named(spans.STEP)))
    if name != SUM_CELL:
        assert crosses == [] and read(ctx) is None
        return
    assert len(crosses) == REQUESTS * (horizon + 1)

    def first_inside(name, lo, hi):
        return min((s, e) for s, e in r.nesting.named(name) if lo <= s and e <= hi)

    for lo, hi in r.nesting.named(spans.POSTERIORS):
        s, e = first_inside("psi.stats", lo, hi)  # the hidden layer's
        assert len([c for c in crosses if lo <= c[0] and c[1] <= hi]) == 1
        assert len([c for c in crosses if s <= c[0] and c[1] <= e]) == 1
    for lo, hi in r.nesting.named(spans.STEP):
        s, e = first_inside("psi.per_t", lo, hi)  # the hidden layer's
        assert len([c for c in crosses if lo <= c[0] and c[1] <= hi]) == 1
        assert len([c for c in crosses if s <= c[0] and c[1] <= e]) == 1
    assert read(ctx) == 0.0  # no device operations on the CPU


def test_eager_steps_read_as_no_graph_replays(served):
    _, r = _traced(served)
    ctx = _ctx(r, units=len(r.nesting.named(spans.STEP)))
    assert not r.nesting.named("rgp.freerun.replay")
    assert run.load_reader("graph_step_share.rollout")(ctx) == 0.0


def test_outputs_are_the_same_bits_with_the_profiler_on(served):
    pc, params, rec, Us, *_ = served
    off = _requests(pc, params, rec, Us)
    on, _ = _traced(served)
    for (m0, v0), (m1, v1) in zip(off, on):
        assert torch.equal(m0, m1) and torch.equal(v0, v1)
        assert torch.isfinite(m0).all() and torch.isfinite(v0).all()


# ------------------------------------------------- the reading, hand-made events


def _events():
    """One request: posteriors [100, 300] with a psi.stats [110, 150], two
    steps [300, 400] and [400, 500], each with a psi.per_t; a launch before
    the request and one in the request outside both; one device operation
    whose launch is not in the trace."""
    E = spans.Event
    ev = [E("span", spans.REQUEST, 90, 520, 0), E("span", spans.POSTERIORS, 100, 300, 0),
          E("span", "psi.stats", 110, 150, 0), E("span", spans.STEP, 300, 400, 0),
          E("span", "psi.per_t", 310, 350, 0), E("span", spans.STEP, 400, 500, 0),
          E("span", "psi.per_t", 410, 450, 0)]
    launches = [(1, 50), (2, 120), (3, 200), (4, 320), (5, 360), (6, 420), (7, 510)]
    ev += [E("launch", "cudaLaunchKernel", t, t + 5, c) for c, t in launches]
    # device operations: (corr, start, end); corr 9 has no launch in the trace
    dev = [(1, 60, 70), (2, 130, 140), (3, 210, 260), (4, 330, 340), (5, 365, 380), (6, 430, 445),
           (7, 515, 530), (9, 600, 610)]
    ev += [E("device", f"k{c}", s, e, c) for c, s, e in dev]
    # waits: one inside the posteriors, one crossing its end, one in a step
    ev += [E("launch", "cudaStreamSynchronize", 160, 190, 20), E("launch", "cudaMemcpy", 290, 305, 21),
           E("launch", "cudaStreamSynchronize", 370, 372, 22), E("launch", "cudaMemcpyAsync", 200, 201, 23)]
    return ev


def _ctx(r, units):
    return SimpleNamespace(kind="rollout", window=None, units=units, span_reading=r)


def test_a_device_op_joins_its_innermost_span_by_correlation_id():
    r = spans.read(_events())
    innermost = {name: (r.nesting.around(t)[0][0] if r.nesting.around(t) else None) for name, _, _, t in r.ops
                 if t is not None}
    assert innermost == {"k1": None, "k2": "psi.stats", "k3": spans.POSTERIORS, "k4": "psi.per_t",
                         "k5": spans.STEP, "k6": "psi.per_t", "k7": spans.REQUEST}
    assert [t for name, _, _, t in r.ops if name == "k9"] == [None]
    assert spans.attribution(r) == {"step": 3, "posteriors": 2, "request": 1, "outside": 1, "unjoined": 1}
    assert sum(spans.attribution(r).values()) == len(r.ops)


def test_the_readers_of_the_hand_made_trace():
    r = spans.read(_events())
    ctx = _ctx(r, units=2)
    assert run.load_reader("step_launches.rollout")(ctx) == pytest.approx(3 / 2)
    assert run.load_reader("posteriors_ms.rollout")(ctx) == pytest.approx(200 / 1e6)
    # the wait at 160-190 lies in the posteriors; 290-305 crosses its end;
    # 370-372 is in a step; cudaMemcpyAsync does not wait
    assert run.load_reader("posterior_syncs.rollout")(ctx) == pytest.approx(1.0)
    # device time launched inside psi.*: k2 (10) + k4 (10) + k6 (15)
    assert run.load_reader("psi_device_ms_per_step.rollout")(ctx) == pytest.approx(35 / 1e6 / 2)


def test_the_idle_share_inside_step_spans_from_hand_made_intervals():
    E = spans.Event
    ev = [E("span", spans.STEP, 100, 200, 0), E("span", spans.STEP, 200, 260, 0)]
    # device busy [0, 50], [80, 120] (with [100, 110] inside), [150, 170], [300, 310]:
    # gaps 50-80, 120-150, 170-300
    ev += [E("device", "k", s, e, 0) for s, e in ((0, 50), (80, 120), (150, 170), (300, 310), (100, 110))]
    r = spans.read(ev)
    assert r.gaps == [(50, 80), (120, 150), (170, 300)]
    # inside steps [100, 260]: 120-150 (30) and 170-260 (90) of 30 + 30 + 130 idle
    assert spans.overlap_ns(r.gaps, r.nesting.named(spans.STEP)) == 120
    assert run.load_reader("step_idle_share.rollout")(_ctx(r, units=2)) == pytest.approx(100 * 120 / 190)


def test_the_cross_terms_device_time_from_hand_made_spans():
    """Device time launched inside ``psi.cross`` spans, over the steps; it is
    also counted once in ``psi_device_ms_per_step.rollout``."""
    E = spans.Event
    ev = [E("span", spans.POSTERIORS, 0, 100, 0), E("span", "psi.stats", 10, 90, 0),
          E("span", "psi.cross", 20, 40, 0), E("span", spans.STEP, 100, 200, 0),
          E("span", "psi.per_t", 110, 190, 0), E("span", "psi.cross", 150, 180, 0)]
    launches = [(1, 15), (2, 25), (3, 120), (4, 160), (5, 195)]
    ev += [E("launch", "cudaLaunchKernel", t, t + 2, c) for c, t in launches]
    ev += [E("device", f"k{c}", 300 + 10 * c, 305 + 10 * c + c, c) for c, _ in launches]
    r = spans.read(ev)
    # k2 (7) in the posteriors' cross term, k4 (9) in the step's
    assert run.load_reader("psi_cross_ms_per_step.rollout")(_ctx(r, units=1)) == pytest.approx(16 / 1e6)
    # k1 (6) + k2 + k3 (8) + k4, the cross terms' once
    assert run.load_reader("psi_device_ms_per_step.rollout")(_ctx(r, units=1)) == pytest.approx(30 / 1e6)


def test_the_share_of_steps_replayed_from_graphs_from_hand_made_spans():
    E = spans.Event
    # three steps: the first holds two replays (one inside a psi.per_t), the
    # second none, the third one; a replay outside every step counts for none
    ev = [E("span", spans.STEP, 100, 200, 0), E("span", "rgp.freerun.replay", 110, 120, 0),
          E("span", "psi.per_t", 130, 150, 0), E("span", "rgp.freerun.replay", 131, 149, 0),
          E("span", spans.STEP, 200, 300, 0), E("span", spans.STEP, 300, 400, 0),
          E("span", "rgp.freerun.replay", 390, 399, 0), E("span", "rgp.freerun.replay", 450, 460, 0)]
    read = run.load_reader("graph_step_share.rollout")
    assert read(_ctx(spans.read(ev), units=3)) == pytest.approx(100 * 2 / 3)
    assert read(_ctx(spans.read([e for e in ev if e.start_ns < 200]), units=1)) == 100.0


def test_the_readers_find_nothing_without_the_program_spans():
    E = spans.Event
    bare = spans.read([E("span", spans.REQUEST, 0, 100, 0), E("launch", "cudaLaunchKernel", 10, 12, 1),
                       E("device", "k", 20, 30, 1), E("launch", "cudaStreamSynchronize", 40, 90, 2)])
    for name in ("posteriors_ms.rollout", "posterior_syncs.rollout", "step_launches.rollout",
                 "psi_device_ms_per_step.rollout", "step_idle_share.rollout", "graph_step_share.rollout",
                 "psi_cross_ms_per_step.rollout"):
        read = run.load_reader(name)
        assert read(_ctx(bare, units=16)) is None
        assert read(SimpleNamespace(kind="rollout", units=0, trace=None)) is None  # no trace, no window
        assert read(SimpleNamespace(kind="fit", units=16, window=None)) is None
