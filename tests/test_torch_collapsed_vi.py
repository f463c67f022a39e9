"""rgp_tpu_torch.inference.collapsed_vi against rgp_tpu.inference.collapsed_vi,
f64 on the CPU, from the same inputs.

Eigenvectors may differ in sign between the two LAPACK builds, so only
outputs that do not depend on them are compared: the whitening's topup and
half log-det (which also show the floor the f32 ladder chose), the bound, the
posterior's alpha and Woodbury inverse, and predictions; rtol 1e-9.
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
from rgp_tpu_torch.ops.psi_stats import PsiStats, psi_statistics

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
