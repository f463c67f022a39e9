"""K3 (``rgp_tpu_torch.ops.cuda.psi2_contract``): each row's RBF Psi2
contracted with the predictive's matrices without forming it, and the route
that ``predict_uncertain`` takes to it.

On the CPU: the plain version against ``predict_uncertain``'s materialised
contraction (Psi2_t formed, then the two einsums) in float64 at config 1's
and config 2's layer shapes, (M, Q) = (100, 20), (100, 16), (100, 12) and
(100, 1), with one and two output columns and a row count that fills no
block evenly (rtol 1e-10: only the summation order differs); the
autograd Function under ``torch.func.vmap`` and a vmap of a vmap equal to
its instances (rtol 1e-12 in float64); the element groups cover the
triangle once; the route rule: on the CPU, in float64, at certain inputs,
for a Sum kernel, an RBF with active dims and with gradients asked for,
``predict_uncertain`` gives the bits of the materialised path as it was
written before K3 and never launches it; its signature, which
``benchmark/faults.py`` patches by name, is unchanged; and the metric
``psi_fused_share.rollout`` on hand-made spans.

On the card (marker ``cuda``; they skip without one): the kernel against
its plain version in float32 at widths 1,024 and 16,384 at both
configurations' layer shapes, one launch a call and the same bits on a
rerun; the rows the kernel plans itself (any row count at the widest Q;
a row too wide for shared memory refused); the route on the card (K3 for a
float32 RBF without gradients, the materialised path's bits otherwise); two
launches a step in config 1's batched freerun; and
``psi_fused_share.rollout`` at 100 in a traced graphed freerun. The graphed
steps' bits against their eager run are held by
``tests/test_torch_freerun_graphs.py``; the route against the JAX
predictive, by ``tests/test_torch_collapsed_vi.py``. This file imports no
JAX.
"""

import inspect
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import drive, faults, inputs, run, spans
from rgp_tpu_torch.bench import serving
from rgp_tpu_torch.inference import collapsed_vi
from rgp_tpu_torch.inference.collapsed_vi import posterior, predict_uncertain
from rgp_tpu_torch.kernels import RBF, Linear
from rgp_tpu_torch.models import rgp
from rgp_tpu_torch.ops import psi_stats
from rgp_tpu_torch.ops.cuda import psi2, psi2_contract as k3

SHAPES = [(100, 20), (100, 16), (100, 12), (100, 1)]  # config 1's layers, then config 2's


def _layer(rng, T, M, Q, D, dtype=torch.float64, device="cpu"):
    """Kernel parameters, Z, uncertain inputs and a posterior-like (alpha,
    W) at (T, M, Q) with D output columns; lengthscale sqrt(Q) keeps Psi2's
    entries O(1) at every width. W is left unsymmetric, as rounding leaves
    the Woodbury inverse."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    p = RBF(input_dim=Q).init(variance=0.8, lengthscale=math.sqrt(Q), dtype=dtype, device=device)
    mu, s, Z = t(rng.standard_normal((T, Q))), t(rng.uniform(0.05, 0.4, (T, Q))), t(rng.standard_normal((M, Q)))
    alpha = t(0.5 * rng.standard_normal((M, D)))
    A = rng.standard_normal((M, M)) / M
    W = t(A @ A.T + 1e-3 * rng.standard_normal((M, M)))
    return p, Z, mu, s, alpha, W


def _materialised(p, Z, mu, s, alpha, W):
    """alpha_d^T Psi2_t alpha_d - tr(W Psi2_t) as ``predict_uncertain``
    computes it where it forms Psi2_t."""
    p2t = psi_stats.psi2_per_t(RBF(input_dim=Z.shape[1]), p, Z, mu, s)
    quad = torch.einsum("md,tmn,nd->td", alpha, p2t, alpha)
    return quad - torch.einsum("mn,tnm->t", W, p2t)[:, None]


def _args(p, Z, mu, s, alpha, W):
    return (*psi2.rbf_psi2_precompute(p, Z, mu, s), Z, alpha, W)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("M,Q", SHAPES)
def test_plain_matches_the_materialised_contraction(M, Q, D):
    rng = np.random.default_rng(M + 7 * Q + D)
    layer = _layer(rng, 37, M, Q, D)
    ours = k3.psi2_contract_plain(*_args(*layer))
    ref = _materialised(*layer)
    assert ours.shape == (37, D) and ours.dtype == torch.float64
    torch.testing.assert_close(ours, ref, rtol=1e-10, atol=1e-12)
    # the same through the Function, from the float32 precompute
    assert torch.equal(k3.rbf_psi2_contract(*layer),
                       k3.psi2_contract_plain(*(x.float().contiguous() for x in _args(*layer))))


def test_plain_takes_more_columns_than_a_launch_in_launches_of_four():
    rng = np.random.default_rng(5)
    layer = _layer(rng, 9, 30, 3, 6)
    torch.testing.assert_close(k3.psi2_contract_plain(*_args(*layer)), _materialised(*layer), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shared", ["alpha_W_Z_shared", "Z_batched"])
def test_function_under_vmap_equals_instances(shared):
    rng = np.random.default_rng(11)
    B, T, M, Q, D = 5, 3, 24, 4, 2
    layers = [_layer(rng, T, M, Q, D) for _ in range(B)]
    base, E, D1, w, Z, alpha, W = (torch.stack(x) for x in zip(*(_args(*ly) for ly in layers)))
    if shared == "alpha_W_Z_shared":
        D1, Z, alpha, W = D1[0], Z[0], alpha[0], W[0]
        in_dims = (0, 0, None, 0, None, None, None)
        each = [k3.RBFPsi2Contract.apply(base[i], E[i], D1, w[i], Z, alpha, W) for i in range(B)]
    else:
        in_dims = (0, 0, 0, 0, 0, None, None)
        alpha, W = alpha[0], W[0]
        each = [k3.RBFPsi2Contract.apply(base[i], E[i], D1[i], w[i], Z[i], alpha, W) for i in range(B)]
    ours = torch.func.vmap(k3.RBFPsi2Contract.apply, in_dims=in_dims)(base, E, D1, w, Z, alpha, W)
    torch.testing.assert_close(ours, torch.stack(each), rtol=1e-12, atol=0)


def test_function_under_nested_vmap_and_through_the_precompute():
    """A vmap of a vmap (rows of candidates of chains) over the precompute
    and the Function, as the batched freerun's steps call it on single
    rows, equals its instances (float64); through ``rbf_psi2_contract``
    (float32) it is the materialised contraction to float32's rounding."""
    rng = np.random.default_rng(12)
    M, Q, D = 16, 3, 1
    p, Z, _, _, alpha, W = _layer(rng, 1, M, Q, D)
    mu = torch.as_tensor(rng.standard_normal((2, 3, 1, Q)))
    s = torch.as_tensor(rng.uniform(0.05, 0.4, (2, 3, 1, Q)))

    def one(m, v):
        return k3.RBFPsi2Contract.apply(*_args(p, Z, m, v, alpha, W))

    ours = torch.func.vmap(torch.func.vmap(one))(mu, s)
    each = torch.stack([torch.stack([one(mu[i, j], s[i, j]) for j in range(3)]) for i in range(2)])
    assert ours.shape == (2, 3, 1, D)
    torch.testing.assert_close(ours, each, rtol=1e-12, atol=0)
    f32 = torch.func.vmap(torch.func.vmap(lambda m, v: k3.rbf_psi2_contract(p, Z, m, v, alpha, W)))(mu, s)
    ref = torch.stack([_materialised(p, Z, mu[i, :, 0], s[i, :, 0], alpha, W) for i in range(2)])
    torch.testing.assert_close(f32[..., 0, :].double(), ref, rtol=1e-5, atol=1e-6)


def test_the_function_has_no_backward():
    rng = np.random.default_rng(13)
    args = [x.clone().requires_grad_() for x in _args(*_layer(rng, 2, 8, 2, 1))]
    out = k3.RBFPsi2Contract.apply(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()


@pytest.mark.parametrize("M,Q,D", [(100, 20, 1), (100, 1, 1), (100, 16, 2), (7, 3, 1), (300, 40, 4), (1, 1, 1)])
def test_element_groups_cover_the_triangle_once(M, Q, D):
    groups, per = k3.element_groups(M, Q, D)
    n = M * (M + 1) // 2
    assert per % k3._THREADS == 0 and per // k3._THREADS <= k3._ept(Q, D)
    assert (groups - 1) * per < n <= groups * per
    if (M, Q, D) == (100, 20, 1):
        assert (groups, per) == (5, 1024)
    if (M, Q, D) == (100, 1, 1):
        assert (groups, per) == (2, 2560)


def test_the_wrapper_checks_its_arguments():
    rng = np.random.default_rng(3)
    args = [x.float().contiguous() for x in _args(*_layer(rng, 4, 6, 2, 1))]
    k3._check(*args)
    with pytest.raises(TypeError, match="float32"):
        k3._check(*(x.double() for x in args))
    with pytest.raises(ValueError, match="shape"):
        k3._check(*args[:5], args[5][:3], args[6])
    with pytest.raises(ValueError, match="contiguous"):
        k3._check(*args[:2], args[2].T, *args[3:])


# ----------------------------------------------------------------- the route


def _predict_materialised(kern, kp, Z, log_noise, post, mu_star, s_star=None, *, include_noise=False):
    """``predict_uncertain`` as it was written before K3."""
    from rgp_tpu_torch.linalg import hdot
    from rgp_tpu_torch.params import positive

    noise = positive(log_noise)
    psi0, psi1 = psi_stats.psi01(kern, kp, Z, mu_star, s_star)
    p2t = psi_stats.psi2_per_t(kern, kp, Z, mu_star, s_star)
    mean = hdot(psi1, post.alpha)
    quad = torch.einsum("md,tmn,nd->td", post.alpha, p2t, post.alpha)
    trace_term = torch.einsum("mn,tnm->t", post.woodbury_inv, p2t)
    var = quad - mean * mean + (psi0 - trace_term)[:, None]
    if include_noise:
        var = var + noise
    return mean, torch.clamp(var, min=1e-12)


def _served_layer(kern, dtype, device, seed=21, T=40, M=12, Ts=9, Q=3):
    """A sparse posterior of ``kern`` on Q = 3 inputs from random targets,
    and uncertain test inputs: what ``predict_uncertain`` takes."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    kp = kern.init(dtype=dtype, device=device)
    Z = t(rng.standard_normal((M, Q)))
    mu, s = t(rng.standard_normal((T, Q))), t(rng.uniform(0.05, 0.3, (T, Q)))
    Y = t(rng.standard_normal((T, 2)))
    log_noise = t(-1.0)
    stats = psi_stats.psi_statistics(kern, kp, Z, mu, s)
    post = posterior(kern, kp, Z, log_noise, stats, Y)
    return kp, Z, log_noise, post, t(rng.standard_normal((Ts, Q))), t(rng.uniform(0.05, 0.3, (Ts, Q)))


def _route_cases():
    rbf = RBF(input_dim=3)
    return {
        "cpu_float32": (rbf, torch.float32, True, False),
        "cpu_float64": (rbf, torch.float64, True, False),
        "certain": (rbf, torch.float64, False, False),
        "sum": (RBF(input_dim=3) + Linear(input_dim=3), torch.float64, True, False),
        "active_dims": (RBF(input_dim=2, active_dims=(0, 2)), torch.float32, True, False),
        "grad": (rbf, torch.float32, True, True),
    }


@pytest.mark.parametrize("case", list(_route_cases()))
def test_the_route_keeps_the_materialised_bits_off_the_card(case):
    kern, dtype, uncertain, grad = _route_cases()[case]
    kp, Z, log_noise, post, mu, s = _served_layer(kern, dtype, "cpu")
    s = s if uncertain else None
    if grad:
        mu = mu.clone().requires_grad_()
    before = k3.launches
    with torch.set_grad_enabled(grad):
        assert not collapsed_vi._contracts_psi2(kern, mu, s, (kp, Z, log_noise, post, mu, s))
        ours = predict_uncertain(kern, kp, Z, log_noise, post, mu, s, include_noise=True)
        ref = _predict_materialised(kern, kp, Z, log_noise, post, mu, s, include_noise=True)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))
    assert k3.launches == before
    if grad:
        g, = torch.autograd.grad(ours[1].sum(), mu)
        assert torch.isfinite(g).all()


def test_predict_uncertains_signature_and_its_patching_by_faults_are_unchanged():
    sig = inspect.signature(predict_uncertain)
    assert [(n, p.kind, p.default) for n, p in sig.parameters.items()] == [
        ("kern", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("kp", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("Z", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("log_noise", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("post", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("mu_star", inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.empty),
        ("s_star", inspect.Parameter.POSITIONAL_OR_KEYWORD, None),
        ("include_noise", inspect.Parameter.KEYWORD_ONLY, False),
        ("psi_region", inspect.Parameter.KEYWORD_ONLY, None),
    ]
    assert rgp.predict_uncertain is predict_uncertain
    with faults.plant("state_unchanged"):
        assert rgp.predict_uncertain is not predict_uncertain
    assert rgp.predict_uncertain is predict_uncertain


# ------------------------------------------------------------------ the metric


def _ctx(r, units):
    return SimpleNamespace(kind="rollout", window=None, units=units, span_reading=r)


def test_the_fused_share_of_hand_made_psi_spans():
    E = spans.Event
    # two steps, each with two psi.per_t spans; K3 launched in three of the four
    ev = [E("span", spans.STEP, 100, 200, 0), E("span", "psi.per_t", 110, 140, 0),
          E("span", "psi.per_t", 150, 190, 0), E("span", spans.STEP, 200, 300, 0),
          E("span", "psi.per_t", 210, 240, 0), E("span", "psi.per_t", 250, 290, 0)]
    launches = [(1, 115), (2, 120), (3, 155), (4, 215), (5, 255), (6, 295)]
    names = {1: "elementwise", 2: "void (anonymous namespace)::psi2_contract_kernel<20, 1>(Args)",
             3: "psi2_contract_kernel<4, 1>", 4: "exp", 5: "psi2_contract_kernel<4, 1>",
             6: "psi2_contract_kernel<4, 1>"}  # 6 is launched outside every psi.per_t
    ev += [E("launch", "cudaLaunchKernel", t, t + 2, c) for c, t in launches]
    ev += [E("device", names[c], 400 + 10 * c, 405 + 10 * c, c) for c, _ in launches]
    read = run.load_reader("psi_fused_share.rollout")
    assert read(_ctx(spans.read(ev), units=2)) == pytest.approx(75.0)
    # the parent: the same spans, no K3
    assert read(_ctx(spans.read([e for e in ev if "psi2_contract" not in e.name]), units=2)) == 0.0
    bare = spans.read([E("span", spans.REQUEST, 0, 100, 0), E("device", "k", 20, 30, 1)])
    assert read(_ctx(bare, units=16)) is None
    assert read(SimpleNamespace(kind="rollout", units=0, trace=None)) is None
    assert read(SimpleNamespace(kind="fit", units=16, window=None)) is None


# ------------------------------------------------------------------- the card


@pytest.fixture
def card(monkeypatch):
    """The CUDA device, and a graph cache of this test's own: the captures
    of its freerun keep no entry that another test's width would find."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(rgp, "step_graphs", rgp.StepGraphs())
    return torch.device("cuda", 0)


def _row_scale(args):
    """sum over the triangle of |weight| x Psi2 a row (float64): the size of
    the terms K3 adds, against which its rounding is judged."""
    base, E, D1, w, Z, alpha, W = (x.double() for x in args)
    M = Z.shape[0]
    m, n = torch.triu_indices(M, M, device=base.device)
    G = k3._weights(alpha, W, m, n).abs()
    logp = base[:, None] + E[:, m] + E[:, n] - D1[m, n] - 0.5 * (w @ (Z[m] * Z[n]).T)
    return torch.exp(logp) @ G


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 16384])
@pytest.mark.parametrize("M,Q,D", [(100, 20, 1), (100, 1, 1), (100, 16, 1), (100, 12, 1), (100, 20, 2)])
def test_k3_matches_its_plain_version_on_card(card, T, M, Q, D):
    rng = np.random.default_rng(T + Q + D)
    layer = _layer(rng, T, M, Q, D, dtype=torch.float64, device=card)
    args = [x.float().contiguous() for x in _args(*layer)]
    before = k3.launches
    ours = k3.psi2_contract(*args)
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and ours.shape == (T, D) and ours.dtype == torch.float32
    ref = k3.psi2_contract_plain(*(x.double() for x in args))
    err = (ours.double() - ref).abs()
    assert bool((err <= 2e-6 * _row_scale(args) + 1e-7).all()), float(err.max())
    assert torch.equal(ours, k3.psi2_contract(*args))  # the same bits on a rerun
    # a ragged row count
    k = k3.psi2_contract(*(x[:T - 3].contiguous() if x.shape[0] == T and x.dim() <= 2 and i in (0, 1, 3) else x
                           for i, x in enumerate(args)))
    assert torch.equal(k, ours[:T - 3])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 37, 1024, 4099])
def test_k3_plans_its_rows_on_card(card, T):
    """The kernel plans its rows a block from its shared memory: at Q = 128
    and M = 300 (27 rows fit) every row count runs and matches the plain
    version; a row of M = 12,300 does not fit in 48 KB, and the launch is
    refused."""
    rng = np.random.default_rng(T)
    layer = _layer(rng, T, 300, 128, 1, dtype=torch.float64, device=card)
    args = [x.float().contiguous() for x in _args(*layer)]
    ours = k3.psi2_contract(*args)
    ref = k3.psi2_contract_plain(*(x.double() for x in args))
    err = (ours.double() - ref).abs()
    assert bool((err <= 2e-6 * _row_scale(args) + 1e-7).all()), float(err.max())
    M = 12300

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=card)

    with pytest.raises(RuntimeError, match="refused"):
        k3.psi2_contract(zeros(2), zeros(2, M), zeros(M, M), zeros(2, 1), zeros(M, 1), zeros(M, 1), zeros(M, M))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32", "float64", "sum", "grad"])
def test_the_route_on_card(card, case):
    kern = RBF(input_dim=3) + Linear(input_dim=3) if case == "sum" else RBF(input_dim=3)
    dtype = torch.float64 if case == "float64" else torch.float32
    kp, Z, log_noise, post, mu, s = _served_layer(kern, dtype, card, M=40, Ts=257)
    if case == "grad":
        mu = mu.clone().requires_grad_()
    before = k3.launches
    with torch.set_grad_enabled(case == "grad"):
        ours = predict_uncertain(kern, kp, Z, log_noise, post, mu, s, include_noise=True)
        ref = _predict_materialised(kern, kp, Z, log_noise, post, mu, s, include_noise=True)
    if case == "float32":
        assert k3.launches == before + 1
        assert torch.equal(ours[0], ref[0])  # the mean is formed as before
        torch.testing.assert_close(ours[1], ref[1], rtol=2e-4, atol=1e-6)
    else:
        assert k3.launches == before
        assert all(torch.equal(a, b) for a, b in zip(ours, ref))


def _served(name, device, width, seed):
    cell = run.load_cell(name)
    cfg = dict(cell.config)
    rec = inputs.record(cfg, torch.float32, device, T=cfg.get("T"))
    gen = inputs.generator(seed, device)
    params = inputs.served_params(cfg, rec, gen, torch.float32)
    return drive.program_cfg(cfg), params, rec, inputs.candidates(cfg, rec, width, cell.traffic["horizon"], gen)


@pytest.mark.cuda
def test_two_launches_a_step_in_config_1s_batched_freerun(card):
    pc, params, rec, Us = _served("rgp1-rollout-w16384", card, 256, 2**32 + 21)
    horizon = Us.shape[1]
    before = k3.launches
    with torch.enable_grad():  # eager steps: every launch goes through the wrapper
        eager = rgp.freerun(pc, params, rec.Y, rec.U, Us)
    assert k3.launches == before + 2 * horizon
    graphed = serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"])
def test_every_psi_span_of_a_graphed_freerun_holds_k3(card, name):
    pc, params, rec, Us = _served(name, card, 64, 2**32 + 23)
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
    steps = r.nesting.named(spans.STEP)
    assert len(r.nesting.named("psi.per_t")) == len(steps) * (pc.n_hidden + 1)
    assert run.load_reader("psi_fused_share.rollout")(_ctx(r, units=len(steps))) == 100.0
