"""The program against the benchmark's plain reference, for each served
configuration: config 1 (RBF-ARD), config 2 (RBF-ARD with back-constraint
MLPs) and config 1 with the hidden kernel RBF-ARD + Linear-ARD
(``benchmark/kernels/rbf_linear_ard.py``).

At a small size on the CPU in float64 (a record of T=64 steps, 12 inducing
points, 16 candidates over 4 steps), on parameters drawn from a seed as the
benchmark draws them: each layer's Psi0, Psi1, per-step Psi2 and Psi2 time
sum against its kernel file; the bound and its gradient (``rgp.neg_elbo``)
and the batched freerun (``serving.batched_freerun``) against
``benchmark/reference.py``. The reference's RBF x Linear cross term is also
held against Gauss-Hermite quadrature, and the comparison is shown to see
it: the reference without it parts from the program by far more than the
rollout's tolerance.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark import drive, inputs, run
from benchmark import reference as ref

CELLS = ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024", "rgp1lin-rollout-w16384"]
SUM_CELL = "rgp1lin-rollout-w16384"
SMALL = {"T": 64, "num_inducing": 12}
WIDTH, HORIZON = 16, 4
LADDER = {"c": [0.2, 4.0]}  # the limits files' band

# Tolerances, each far above the float64 rounding it allows for (the gaps
# read at these sizes in brackets, over the three configurations).
# Psi terms: the same closed forms by different algebra (the program expands
# the exponent's quadratic and splits the cross term in three, the reference
# takes a midpoint form and the cross term's xt); exponents reach ~1e2, so
# rounding moves a value by ~1e-14 of the largest entry [1e-14].
PSI_RTOL, PSI_ATOL = 1e-10, 1e-12
# The bound: the same float64 sums at the same detached whitening basis and
# jitter rungs, ordered differently [1.4e-13 of the bound].
BOUND_RTOL = 1e-10
# The gradient passes the whitened Cholesky factors of Ct, whose condition
# number at these sizes reaches ~1e6, so rounding grows by as much
# [3.7e-11 of the largest component].
GRAD_RTOL, GRAD_ATOL = 1e-7, 1e-9
# The rollout: four moment-matched steps, each through the posterior's
# solves with that conditioning [1.6e-12; 0.26 without the cross term].
ROLLOUT_TOL = 1e-8


def _setup(name, seed=3):
    cell = run.load_cell(name)
    cfg = dict(cell.config, **SMALL, jitter=1e-12)  # the program's float64 jitter base
    cfg.pop("served_params")  # fitted at the full size
    cpu = torch.device("cpu")
    rec = inputs.record(cfg, torch.float64, cpu, T=cfg["T"])
    params = inputs.member(inputs.init_params(cfg, rec, 1, inputs.generator(seed, cpu), torch.float64), 0)
    return cfg, rec, params


def _perturbed(params, seed=7):
    """The seeded parameters with every kernel leaf moved off its initial
    value, so that no part of a kernel sits at a symmetric point."""
    g = torch.Generator().manual_seed(seed)
    leaves = [x + 0.3 * torch.randn(x.shape, generator=g, dtype=x.dtype) if "/kern/" in k else x
              for k, x in ref.tree_leaves(params)]
    return ref.tree_with(params, leaves)


def _grad(loss, leaves, **kw):
    """The gradient of each leaf, 0 for a leaf the loss does not use (the
    latent means that back-constraint MLPs replace)."""
    g = torch.autograd.grad(loss, leaves, allow_unused=True, **kw)
    return [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, g)]


def _close(a, b, rtol, atol):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("name", CELLS)
def test_psi_statistics_match_the_kernel_files(name):
    from rgp_tpu_torch.ops import psi_stats

    cfg, rec, params = _setup(name)
    params = _perturbed(params)
    pc = drive.program_cfg(cfg)
    layers, _, _ = ref.layers_of(cfg, params, rec.Y, rec.U)
    kernels = [s.kernel for s in pc.layers] + [pc.out_kernel]
    assert len(layers) == len(kernels)
    for kern, d in zip(kernels, layers):
        p = d.kf.hyper(d.kp)
        mu, s = d.X_mu, d.X_s
        psi0, psi1 = psi_stats.psi01(kern, d.kp, d.Z, mu, s)
        _close(psi0, d.kf.psi0(p, mu, s), PSI_RTOL, PSI_ATOL)
        _close(psi1, d.kf.psi1(p, d.Z, mu, s), PSI_RTOL, PSI_ATOL)
        _close(psi_stats.psi2_per_t(kern, d.kp, d.Z, mu, s), d.kf.psi2(p, d.Z, mu, s), PSI_RTOL, PSI_ATOL)
        st = psi_stats.psi_statistics(kern, d.kp, d.Z, mu, s, block=16)
        _close(st.psi2, d.kf.psi2_sum(p, d.Z, mu, s, 16), PSI_RTOL, PSI_ATOL)
        _close(st.psi0, d.kf.psi0(p, mu, s), PSI_RTOL, PSI_ATOL)
    assert [type(k).__name__ for k in kernels[:1]] == (["Sum"] if name == SUM_CELL else ["RBF"])


@pytest.mark.parametrize("name", CELLS)
def test_bound_and_gradient_match_the_program(name):
    from rgp_tpu_torch.models import rgp

    cfg, rec, params = _setup(name)
    pc = drive.program_cfg(cfg)
    leaves = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
    loss = rgp.neg_elbo(pc, ref.tree_with(params, leaves), rec.Y, rec.U, block=None)
    g_prog = _grad(loss, leaves)

    best = None
    ladder = ref.Ladder(LADDER)
    for bases in itertools.product(*ref.refresh(cfg, params, rec.Y, rec.U, ladder)):
        rl = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
        for _, rloss in ref.neg_elbo(cfg, ref.tree_with(params, rl), rec.Y, rec.U, list(bases), ladder=ladder):
            gap = abs(float(rloss) - float(loss)) / abs(float(loss))
            if best is None or gap < best[0]:
                best = (gap, _grad(rloss, rl, retain_graph=True))
    assert best[0] < BOUND_RTOL
    for a, b in zip(g_prog, best[1]):
        _close(a, b, GRAD_RTOL, GRAD_ATOL)


def _rollout_gap(cfg, rec, params, Us, m, v):
    """The gap of the reference branch nearest the program's (means, variances)."""
    return min(max(float((m - mr).abs().max()), float(((v - vr) / vr).abs().max()))
               for _, mr, vr in ref.rollout_branches(cfg, params, rec.Y, rec.U, Us, ref.Ladder(LADDER)))


def _rollout(name):
    from rgp_tpu_torch.bench import serving

    cfg, rec, params = _setup(name)
    Us = inputs.candidates(cfg, rec, WIDTH, HORIZON, inputs.generator(5, torch.device("cpu")))
    m, v = serving.batched_freerun(drive.program_cfg(cfg), params, rec.Y, rec.U, Us)
    assert m.shape == v.shape == (WIDTH, HORIZON, 1)
    return cfg, rec, params, Us, m, v


@pytest.mark.parametrize("name", CELLS)
def test_rollout_matches_the_program(name):
    assert _rollout_gap(*_rollout(name)) < ROLLOUT_TOL


def test_the_rollout_without_the_cross_term_parts_from_the_program(monkeypatch):
    cfg, rec, params, Us, m, v = _rollout(SUM_CELL)
    kf = ref.kernel_file("rbf_linear_ard")
    monkeypatch.setattr(kf, "cross", lambda p, Z, mu, s: mu.new_zeros(mu.shape[0], Z.shape[0], Z.shape[0]))
    assert _rollout_gap(cfg, rec, params, Us, m, v) > 1e6 * ROLLOUT_TOL


def _gauss_hermite_2d(n, mu, s):
    """Nodes (n*n, 2) and weights (n*n,) of E f(x), x ~ N(mu, diag s)."""
    y, w = np.polynomial.hermite.hermgauss(n)
    yy = np.stack(np.meshgrid(y, y, indexing="ij"), -1).reshape(-1, 2)
    ww = np.outer(w, w).reshape(-1) / math.pi
    x = torch.as_tensor(mu)[None] + torch.sqrt(2.0 * torch.as_tensor(s))[None] * torch.as_tensor(yy)
    return x, torch.as_tensor(ww)


def test_the_reference_cross_term_against_gauss_hermite_quadrature():
    """E[k_rbf(x, z_m) k_lin(x, z_n)] at Q=2 by a 40 x 40 tensor-product
    Gauss-Hermite rule: the integrand is a Gaussian in x of width l times a
    linear function, and at input sds up to 1.05 l the rule's error is at
    float64 rounding (2e-8 at 20 x 20, 7e-16 at 40 x 40). The whole Psi2
    holds the RBF factor squared, half as wide, so it takes 60 x 60 (9e-11
    at 40 x 40, 4e-15 at 60 x 60)."""
    kf = ref.kernel_file("rbf_linear_ard")
    g = torch.Generator().manual_seed(11)
    dt = torch.float64
    kp = ({"log_var": torch.tensor(0.4, dtype=dt), "log_ls": torch.tensor([0.3, 1.2], dtype=dt)},
          {"log_var": torch.tensor([-0.5, 0.8], dtype=dt)})
    p = kf.hyper(kp)
    Z = torch.randn(5, 2, generator=g, dtype=dt)
    mu = torch.randn(3, 2, generator=g, dtype=dt)
    s = 0.05 + torch.rand(3, 2, generator=g, dtype=dt)
    got, got2 = kf.cross(p, Z, mu, s), kf.psi2(p, Z, mu, s)
    for t in range(mu.shape[0]):
        x, w = _gauss_hermite_2d(40, mu[t], s[t])
        want = torch.einsum("i,im,in->mn", w, kf.rbf.K(p[0], x, Z), x @ (Z * p[1]["v"]).T)
        _close(got[t], want, 1e-12, 1e-13)
        x, w = _gauss_hermite_2d(60, mu[t], s[t])
        k = kf.K(p, x, Z)
        _close(got2[t], torch.einsum("i,im,in->mn", w, k, k), 1e-12, 1e-13)
