"""rgp_tpu_torch.inference.collapsed_vi against rgp_tpu.inference.collapsed_vi,
f64 on the CPU, from the same inputs.

Eigenvectors may differ in sign between the two LAPACK builds, so only
outputs that do not depend on them are compared: the whitening's topup and
half log-det (which also show the floor the f32 ladder chose), the bound, the
posterior's alpha and Woodbury inverse, and predictions; rtol 1e-9.

The predictive's contraction by K3 (``ops/cuda/psi2_contract``), which
forms no Psi2_t, is held against the JAX predictive on the same inputs and
posterior at config 1's and config 2's layer shapes: its plain version in
float64 (rtol 1e-9), ``predict_uncertain``'s route through it with float32
inputs (on the CPU the route is forced, so the plain version runs; marker
``cuda``: taken on the card, where the kernel runs) against the JAX
predictive of the same float32 values in float64, at float32's rounding of
the terms the variance sums. JAX runs on the CPU in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.inference import collapsed_vi as jvi
from rgp_tpu.kernels import RBF as JRBF
from rgp_tpu.ops.psi_stats import psi_statistics as jpsi
from rgp_tpu_torch.inference import collapsed_vi as tvi
from rgp_tpu_torch.kernels import RBF
from rgp_tpu_torch.ops.cuda import psi2, psi2_contract as k3
from rgp_tpu_torch.ops.psi_stats import PsiStats, psi01, psi_statistics
from rgp_tpu_torch.params import positive

RTOL = 1e-9


def _problem(seed, T=40, M=12, Q=3, dup=None):
    """Inputs, targets and both packages' psi statistics. ``dup`` puts two
    inducing points within ``dup`` of a third (near-singular Kmm)."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((M, Q))
    if dup is not None:
        Z[1], Z[2] = Z[0] + dup, Z[0] - dup
    mu = rng.standard_normal((T, Q))
    s = rng.uniform(0.05, 0.4, (T, Q))
    Y = rng.standard_normal((T, 2))
    Yv = rng.uniform(0.01, 0.1, (T, 2))
    jp = JRBF(input_dim=Q).init(lengthscale=np.linspace(0.8, 1.5, Q), dtype=jnp.float64)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    jst = jpsi(JRBF(input_dim=Q), jp, jnp.asarray(Z), jnp.asarray(mu), jnp.asarray(s), block=None)
    tst = psi_statistics(RBF(input_dim=Q), tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s),
                         block=None)
    return dict(Z=Z, mu=mu, s=s, Y=Y, Yv=Yv, jp=jp, tp=tp, jst=jst, tst=tst, Q=Q)


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=0)


# near-singular Kmm; with growing beta the f32 trial Cholesky keeps the base
# floor, escalates it once (x1e3), and twice (x1e6)
@pytest.mark.parametrize("beta,escalates", [(1e2, False), (1e4, True), (1e6, True)])
def test_whitening_basis_matches_jax(beta, escalates):
    P = _problem(3, dup=1e-5)
    Kt = RBF(input_dim=P["Q"]).K(P["tp"], torch.tensor(P["Z"]))
    Kj = JRBF(input_dim=P["Q"]).K(P["jp"], jnp.asarray(P["Z"]))
    ours = tvi.whitening_basis(Kt, P["tst"].psi2, torch.tensor(beta, dtype=torch.float64))
    ref = jvi.whitening_basis(Kj, P["jst"].psi2, jnp.asarray(beta))
    base = tvi.whitening_basis(Kt)
    assert bool((ours.topup != base.topup).any()) == escalates
    _close(ours.topup, ref.topup, rtol=1e-7)  # 1 - lam/lam_eff: eigenvalue rounding
    _close(ours.half_logdet, ref.half_logdet)
    # W spans the same whitened space: W^T Kmm W + diag(topup) = I
    I = ours.W.T @ Kt @ ours.W + torch.diag(ours.topup)
    np.testing.assert_allclose(I.numpy(), np.eye(Kt.shape[0]), atol=1e-6)


@pytest.mark.parametrize("variational", [False, True])
def test_collapsed_bound_matches_jax(variational):
    P = _problem(2)
    kw_t = dict(Y_var=torch.tensor(P["Yv"])) if variational else {}
    kw_j = dict(Y_var=jnp.asarray(P["Yv"])) if variational else {}
    ln = -1.5
    ours = tvi.collapsed_bound(RBF(input_dim=P["Q"]), P["tp"], torch.tensor(P["Z"]),
                               torch.tensor(ln, dtype=torch.float64), P["tst"],
                               torch.tensor(P["Y"]), **kw_t)
    ref = jvi.collapsed_bound(JRBF(input_dim=P["Q"]), P["jp"], jnp.asarray(P["Z"]),
                              jnp.asarray(ln), P["jst"], jnp.asarray(P["Y"]), **kw_j)
    _close(ours, ref)


def test_collapsed_bound_certain_factor_matches_jax():
    P = _problem(3)
    kt, kj = RBF(input_dim=P["Q"]), JRBF(input_dim=P["Q"])
    st = psi_statistics(kt, P["tp"], torch.tensor(P["Z"]), torch.tensor(P["mu"]), None)
    sj = jpsi(kj, P["jp"], jnp.asarray(P["Z"]), jnp.asarray(P["mu"]), None)
    ours = tvi.collapsed_bound(kt, P["tp"], torch.tensor(P["Z"]), torch.tensor(-2.0, dtype=torch.float64),
                               st, torch.tensor(P["Y"]), certain=True)
    ref = jvi.collapsed_bound(kj, P["jp"], jnp.asarray(P["Z"]), jnp.asarray(-2.0), sj,
                              jnp.asarray(P["Y"]), certain=True)
    _close(ours, ref)


def _posteriors(P, ln=-1.5):
    kt, kj = RBF(input_dim=P["Q"]), JRBF(input_dim=P["Q"])
    pt = tvi.posterior(kt, P["tp"], torch.tensor(P["Z"]), torch.tensor(ln, dtype=torch.float64),
                       P["tst"], torch.tensor(P["Y"]))
    pj = jvi.posterior(kj, P["jp"], jnp.asarray(P["Z"]), jnp.asarray(ln), P["jst"], jnp.asarray(P["Y"]))
    return kt, kj, pt, pj


def test_posterior_matches_jax():
    P = _problem(4)
    _, _, pt, pj = _posteriors(P)
    _close(pt.alpha, pj.alpha)
    _close(pt.woodbury_inv, pj.woodbury_inv)
    _close(pt.W, pj.W)


@pytest.mark.parametrize("uncertain,include_noise", [(True, True), (True, False), (False, True)])
def test_predict_uncertain_matches_jax(uncertain, include_noise):
    P = _problem(5)
    kt, kj, pt, pj = _posteriors(P)
    rng = np.random.default_rng(50)
    ms = rng.standard_normal((7, P["Q"]))
    ss = rng.uniform(0.01, 0.3, (7, P["Q"])) if uncertain else None
    ours = tvi.predict_uncertain(kt, P["tp"], torch.tensor(P["Z"]), torch.tensor(-1.5, dtype=torch.float64),
                                 pt, torch.tensor(ms), None if ss is None else torch.tensor(ss),
                                 include_noise=include_noise)
    ref = jvi.predict_uncertain(kj, P["jp"], jnp.asarray(P["Z"]), jnp.asarray(-1.5), pj,
                                jnp.asarray(ms), None if ss is None else jnp.asarray(ss),
                                include_noise=include_noise)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_predict_certain_matches_jax():
    P = _problem(6)
    kt, kj, pt, pj = _posteriors(P)
    Xs = np.random.default_rng(60).standard_normal((5, P["Q"]))
    for full_cov in (False, True):
        ours = tvi.predict_certain(kt, P["tp"], torch.tensor(P["Z"]), torch.tensor(-1.5, dtype=torch.float64),
                                   pt, torch.tensor(Xs), full_cov=full_cov, include_noise=True)
        ref = jvi.predict_certain(kj, P["jp"], jnp.asarray(P["Z"]), jnp.asarray(-1.5), pj,
                                  jnp.asarray(Xs), full_cov=full_cov, include_noise=True)
        for a, b in zip(ours, ref):
            _close(a, b)


def test_psi_stats_tuple_is_a_namedtuple():
    st = PsiStats(torch.zeros(2), torch.zeros(2, 3), torch.zeros(3, 3))
    assert st.psi2.shape == (3, 3) and st._fields == ("psi0", "psi1", "psi2")


# ------------------------------------------------ K3 against the JAX predictive

K3_SHAPES = [(100, 20), (100, 16), (100, 12), (100, 1)]  # config 1's layers, then config 2's
K3_LOG_NOISE = -1.5


def _k3_case(seed, T, M, Q, D):
    """An RBF layer's parameters (JAX), inducing inputs, uncertain inputs and
    a posterior-like (alpha, Woodbury inverse) in numpy float64; the
    lengthscales ~sqrt(Q) keep Psi2's entries O(1) at every width, and the
    Woodbury inverse is left unsymmetric, as rounding leaves it."""
    rng = np.random.default_rng(seed)
    jp = JRBF(input_dim=Q).init(variance=0.8, lengthscale=np.sqrt(Q) * np.linspace(0.8, 1.2, Q), dtype=jnp.float64)
    A = rng.standard_normal((M, M)) / M
    return dict(jp={k: np.asarray(v) for k, v in jp.items()}, Z=rng.standard_normal((M, Q)),
                mu=rng.standard_normal((T, Q)), s=rng.uniform(0.05, 0.4, (T, Q)),
                alpha=0.5 * rng.standard_normal((M, D)), W=A @ A.T + 1e-3 * rng.standard_normal((M, M)))


def _k3_jax(C, Q, include_noise):
    """The JAX package's predictive (mean, var) of the case, float64."""
    post = jvi.SparsePosterior(alpha=jnp.asarray(C["alpha"]), woodbury_inv=jnp.asarray(C["W"]),
                               W=jnp.asarray(C["W"]))
    return jvi.predict_uncertain(JRBF(input_dim=Q), {k: jnp.asarray(v) for k, v in C["jp"].items()},
                                 jnp.asarray(C["Z"]), jnp.asarray(K3_LOG_NOISE), post, jnp.asarray(C["mu"]),
                                 jnp.asarray(C["s"]), include_noise=include_noise)


@pytest.mark.parametrize("D", [1, 2, 5])
@pytest.mark.parametrize("M,Q", K3_SHAPES)
def test_k3_contraction_gives_the_jax_predictive(M, Q, D):
    """The variance assembled as the route assembles it from K3's plain
    version (its quad - trace, - mean^2 + psi0 + noise) is the JAX
    predictive's, float64, at a row count that fills no block evenly and at
    more columns than a launch takes."""
    C = _k3_case(70 + Q + D, 37, M, Q, D)
    tp = {k: torch.tensor(v) for k, v in C["jp"].items()}
    Z, mu, s, alpha, W = (torch.tensor(C[k]) for k in ("Z", "mu", "s", "alpha", "W"))
    psi0, psi1 = psi01(RBF(input_dim=Q), tp, Z, mu, s)
    quad_trace = k3.psi2_contract_plain(*psi2.rbf_psi2_precompute(tp, Z, mu, s), Z, alpha, W)
    mean = psi1 @ alpha
    var = torch.clamp(quad_trace - mean * mean + psi0[:, None]
                      + positive(torch.tensor(K3_LOG_NOISE, dtype=torch.float64)), min=1e-12)
    ref = _k3_jax(C, Q, include_noise=True)
    _close(mean, ref[0])
    _close(var, ref[1])


def _k3_route_against_jax(C, Q, device, include_noise):
    """``predict_uncertain`` on the case's values rounded to float32 on
    ``device``, and the JAX predictive of the same float32 values in float64:
    (ours, ref, scale), ``scale`` (T, D) the sum of the magnitudes of the
    terms the variance adds (psi0, the mean's square and every weighted
    Psi2 element), against which float32's rounding is judged."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    C32 = {k: ({n: np.asarray(v, np.float32).astype(np.float64) for n, v in x.items()} if k == "jp"
               else np.asarray(x, np.float32).astype(np.float64)) for k, x in C.items()}
    post = tvi.SparsePosterior(f32(C["alpha"]), f32(C["W"]), f32(C["W"]))
    ours = tvi.predict_uncertain(RBF(input_dim=Q), {k: f32(v) for k, v in C["jp"].items()}, f32(C["Z"]),
                                 torch.tensor(K3_LOG_NOISE, dtype=torch.float32, device=device), post,
                                 f32(C["mu"]), f32(C["s"]), include_noise=include_noise)
    ref = _k3_jax(C32, Q, include_noise)
    tp = {k: torch.tensor(v) for k, v in C32["jp"].items()}
    Z, mu, s, alpha, W = (torch.tensor(C32[k]) for k in ("Z", "mu", "s", "alpha", "W"))
    M = Z.shape[0]
    base, E, D1, w = psi2.rbf_psi2_precompute(tp, Z, mu, s)
    m, n = torch.triu_indices(M, M)
    p2 = torch.exp(base[:, None] + E[:, m] + E[:, n] - D1[m, n] - 0.5 * (w @ (Z[m] * Z[n]).T))
    psi0, psi1 = psi01(RBF(input_dim=Q), tp, Z, mu, s)
    scale = p2 @ k3._weights(alpha, W, m, n).abs() + (psi1 @ alpha) ** 2 + psi0[:, None]
    return [x.detach().cpu().double() for x in ours], [torch.tensor(np.asarray(x)) for x in ref], scale


def _assert_float32_close(ours, ref, scale):
    for name, a, b in (("mean", ours[0], ref[0]), ("var", ours[1], ref[1])):
        err = (a - b).abs()
        tol = (2e-6 * scale if name == "var" else 1e-5 * b.abs().max()) + 1e-7
        assert bool((err <= tol).all()), f"{name}: worst err/tol {float((err / tol).max())}"


@pytest.mark.parametrize("include_noise", [True, False])
@pytest.mark.parametrize("M,Q", K3_SHAPES)
def test_predict_uncertain_through_k3_matches_jax(monkeypatch, M, Q, include_noise):
    """The K3 route of ``predict_uncertain`` with float32 inputs, forced on
    the CPU (the plain version in float32 stands in for the kernel), against
    the JAX predictive of the same values."""
    C = _k3_case(90 + Q, 37, M, Q, 2)
    calls = []
    contracted = tvi.psi2_contracted
    monkeypatch.setattr(tvi, "_contracts_psi2", lambda *a: True)
    monkeypatch.setattr(tvi, "psi2_contracted", lambda *a: calls.append(1) or contracted(*a))
    with torch.no_grad():
        ours, ref, scale = _k3_route_against_jax(C, Q, "cpu", include_noise)
    assert calls == [1] and ours[1].shape == (37, 2)
    _assert_float32_close(ours, ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Q", K3_SHAPES)
def test_predict_uncertain_through_k3_on_card_matches_jax(M, Q):
    """On the card the route launches K3 (once) for float32 inputs with no
    gradient; its mean and variance against the JAX predictive of the same
    float32 values, computed on the host's CPU in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = _k3_case(110 + Q, 1024, M, Q, 1)
    before = k3.launches
    with torch.no_grad():
        ours, ref, scale = _k3_route_against_jax(C, Q, torch.device("cuda", 0), True)
    assert k3.launches == before + 1
    _assert_float32_close(ours, ref, scale)
