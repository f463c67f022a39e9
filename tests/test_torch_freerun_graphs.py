"""The freerun split into posteriors, starting state and one closed-loop step,
and the CUDA graphs of that step that a batched freerun replays.

On the CPU, for both served configurations (config 1's one-layer RGP,
config 2's two-layer RGP with back-constraint MLPs) cut to a short record
and 12 inducing points, float64, a batch of 6 candidates over 8 steps:
``rgp.freerun`` of one sequence and of the batch give the same bits as the
freerun written as one loop (:func:`_loop_freerun`, the form the split
replaced) and ``torch.func.vmap`` of it, and the batch never
captures a graph there.

On the card (marker ``cuda``; they skip without one), at the served
configurations' full size: graph replay gives the same bits as the same
batched steps run eagerly (grad on, which keeps them eager) at widths 64
and 1024; a second parameter set of the same shapes gives its own eager
answer; a new width captures anew; replays count horizon x requests; and in
a profiler trace every replay lies in its step's span, those of the Psi
terms in ``psi.per_t``. This file imports no JAX.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import drive, inputs, run, spans
from rgp_tpu_torch.bench import serving
from rgp_tpu_torch.data.windows import current_window
from rgp_tpu_torch.inference.collapsed_vi import predict_uncertain
from rgp_tpu_torch.models import rgp

CELLS = ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"]
REPLAY = "rgp.freerun.replay"


def _loop_freerun(cfg, params, Y_train, U_train, U_test):
    """The moment-matched freerun from the tail of the trained means as one
    loop, as ``rgp.freerun`` was written before its step became a function."""
    posts, _ = rgp._posteriors(cfg, params, Y_train, U_train)
    H = cfg.n_hidden
    mus, lams = rgp._hidden_moments(cfg, params, Y_train, U_train)
    buf_lens = [max(spec.win, cfg.layers[h + 1].win if h + 1 < H else cfg.out_win)
                for h, spec in enumerate(cfg.layers)]
    bufs_mu = [torch.flip(mus[h][-B:], [0]) for h, B in enumerate(buf_lens)]
    bufs_s = [torch.flip(lams[h][-B:], [0]) for h, B in enumerate(buf_lens)]
    Lu = cfg.u_win
    U_cat = torch.cat([U_train[-(Lu - 1):], U_test], dim=0)
    Uw = current_window(U_cat, Lu)[Lu - 1:]
    fl_noise = [rgp._fln(cfg, lp["log_noise"]) for lp in params["layers"]]
    op = params["out"]
    fl_out = rgp._fln(cfg, op["log_noise"])
    y_means, y_vars = [], []
    for i in range(Uw.shape[0]):
        new_mu, new_s = [], []
        for h, spec in enumerate(cfg.layers):
            lp = params["layers"][h]
            L = spec.win
            own_mu = bufs_mu[h][:L].reshape(1, -1)
            own_s = bufs_s[h][:L].reshape(1, -1)
            if h == 0:
                low_mu = Uw[i].reshape(1, -1)
                low_s = torch.zeros_like(low_mu)
            else:
                q_lo = cfg.layers[h - 1].q_dim
                low_mu = rgp._window(new_mu[h - 1], bufs_mu[h - 1], L, q_lo)
                low_s = rgp._window(new_s[h - 1], bufs_s[h - 1], L, q_lo)
            m, v = predict_uncertain(spec.kernel, lp["kern"], lp["Z"], fl_noise[h], posts[h],
                                     torch.cat([own_mu, low_mu], dim=-1), torch.cat([own_s, low_s], dim=-1),
                                     include_noise=True)
            new_mu.append(m[0])
            new_s.append(v[0])
        q_top = cfg.layers[-1].q_dim
        top_mu = rgp._window(new_mu[-1], bufs_mu[-1], cfg.out_win, q_top)
        top_s = rgp._window(new_s[-1], bufs_s[-1], cfg.out_win, q_top)
        ym, yv = predict_uncertain(cfg.out_kernel, op["kern"], op["Z"], fl_out, posts[-1], top_mu, top_s,
                                   include_noise=True)
        bufs_mu = [torch.cat([new_mu[h][None, :], bufs_mu[h][:-1]], dim=0) for h in range(H)]
        bufs_s = [torch.cat([new_s[h][None, :], bufs_s[h][:-1]], dim=0) for h in range(H)]
        y_means.append(ym[0])
        y_vars.append(yv[0])
    return torch.stack(y_means), torch.stack(y_vars)


def _served(name, dtype, device, *, width, seed, small):
    """(program config, parameters, record, [candidates]) of cell ``name``;
    ``small`` cuts the record to 64 steps and 12 inducing points, with
    parameters drawn from ``seed`` in place of the fitted ones."""
    cell = run.load_cell(name)
    cfg = dict(cell.config)
    if small:
        cfg.update(T=64, num_inducing=12)
        cfg.pop("served_params", None)  # fitted at the full size
    rec = inputs.record(cfg, dtype, device, T=cfg.get("T"))
    gen = inputs.generator(seed, device)
    params = inputs.served_params(cfg, rec, gen, dtype)
    horizon = 8 if small else cell.traffic["horizon"]
    return drive.program_cfg(cfg), params, rec, inputs.candidates(cfg, rec, width, horizon, gen)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_split_freerun_gives_the_bits_of_the_loop_and_never_captures_on_the_cpu(name):
    cpu = torch.device("cpu")
    pc, params, rec, Us = _served(name, torch.float64, cpu, width=6, seed=2**33 + 11, small=True)
    captures, replays = rgp.step_graphs.captures, rgp.step_graphs.replays
    with torch.no_grad():
        for b in (0, 5):
            ref = _loop_freerun(pc, params, rec.Y, rec.U, Us[b])
            ours = rgp.freerun(pc, params, rec.Y, rec.U, Us[b])
            assert all(torch.equal(a, o) for a, o in zip(ref, ours))
        ref = torch.func.vmap(lambda u: _loop_freerun(pc, params, rec.Y, rec.U, u))(Us)
    ours = serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
    assert ours[0].shape == ours[1].shape == (6, 8, 1)
    assert torch.equal(ref[0], ours[0]) and torch.equal(ref[1], ours[1])
    assert torch.isfinite(ours[0]).all() and (ours[1] > 0).all()
    assert (rgp.step_graphs.captures, rgp.step_graphs.replays) == (captures, replays)


def test_only_kernels_without_host_copies_are_captured():
    from rgp_tpu_torch.kernels import RBF, Linear

    assert rgp._host_free(RBF(input_dim=3))
    assert not rgp._host_free(RBF(input_dim=3, active_dims=(0, 1)))
    assert not rgp._host_free(RBF(input_dim=3) + Linear(input_dim=3))
    cfg = rgp.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=4)
    with torch.no_grad():
        assert not rgp._capturable(cfg, (torch.zeros(2, 3),))  # a CPU tensor


# ------------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eager(pc, params, rec, Us):
    """The same batched steps run eagerly: with grad on they are not captured."""
    with torch.enable_grad():
        return rgp.freerun(pc, params, rec.Y, rec.U, Us)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 1024])
@pytest.mark.parametrize("name", CELLS)
def test_graph_replay_gives_the_eager_bits_and_new_parameters_their_own(card, name, width):
    pc, params, rec, Us = _served(name, torch.float32, card, width=width, seed=2**32 + 7, small=False)
    captures, replays = rgp.step_graphs.captures, rgp.step_graphs.replays
    graphed = serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
    assert rgp.step_graphs.captures == captures + 1
    assert _same_bits(graphed, _eager(pc, params, rec, Us))
    # a second parameter set of the same shapes and layouts, and new candidates: replayed, not captured
    gen = inputs.generator(2**31 + 3, card)

    def moved(Z):
        return torch.empty_like(Z).copy_(Z + 0.05 * torch.randn(Z.shape, generator=gen, device=card))

    other = {**params, "layers": [{**lp, "Z": moved(lp["Z"])} for lp in params["layers"]]}
    Us2 = Us.flip(0)
    again = serving.batched_freerun(pc, other, rec.Y, rec.U, Us2)
    assert rgp.step_graphs.captures == captures + 1
    assert _same_bits(again, _eager(pc, other, rec, Us2))
    assert not torch.equal(again[0], graphed[0].flip(0))
    horizon = Us.shape[1]
    assert rgp.step_graphs.replays == replays + 2 * horizon
    assert torch.isfinite(graphed[0]).all() and torch.isfinite(again[0]).all()


@pytest.mark.cuda
def test_a_new_width_captures_anew_and_replays_count_steps(card):
    pc, params, rec, Us = _served(CELLS[1], torch.float32, card, width=48, seed=2**33 + 1, small=False)
    captures, replays = rgp.step_graphs.captures, rgp.step_graphs.replays
    horizon = Us.shape[1]
    for _ in range(3):
        serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
    assert rgp.step_graphs.captures == captures + 1
    serving.batched_freerun(pc, params, rec.Y, rec.U, Us[:40])
    assert rgp.step_graphs.captures == captures + 2
    serving.batched_freerun(pc, params, rec.Y, rec.U, Us[:, :5])
    assert rgp.step_graphs.captures == captures + 3
    assert rgp.step_graphs.replays == replays + 4 * horizon + 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_replay_lies_in_its_step_and_psi_spans(card, name):
    pc, params, rec, Us = _served(name, torch.float32, card, width=64, seed=2**32 + 9, small=False)
    serving.batched_freerun(pc, params, rec.Y, rec.U, Us)  # captured outside the trace
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    r = spans.read(spans.events_of(prof))
    steps, replays = r.nesting.named(spans.STEP), r.nesting.named(REPLAY)
    layers = pc.n_hidden + 1
    assert len(steps) == Us.shape[1]
    assert len(replays) == len(steps) * (2 * layers + 1)
    for lo, hi in steps:
        inside = [(s, e) for s, e in replays if lo <= s and e <= hi]
        assert len(inside) == 2 * layers + 1
        in_psi = [spans.PSI + "per_t" in r.holding(s) for s, _ in inside]
        assert in_psi == [k % 2 == 1 for k in range(2 * layers + 1)]
    ctx = SimpleNamespace(kind="rollout", window=None, span_reading=r, units=len(steps))
    assert run.load_reader("graph_step_share.rollout")(ctx) == 100.0
    # the graphs' device operations join the launches inside the steps and Psi spans
    assert run.load_reader("step_launches.rollout")(ctx) > 0
    assert run.load_reader("psi_device_ms_per_step.rollout")(ctx) > 0
