"""The port's samplers on analytic targets (the gates of tests/test_samplers.py
at its tolerances), the pure pieces of NUTS against rgp_tpu.sample.nuts in
f64, the diagnostics array-equal to rgp_tpu.sample.diagnostics, and the two
properties the chain axis must keep: a batched transition over C chains
equals C one-chain transitions bit for bit (the masking), and warmup cut
into segments equals one call bit for bit.

Potentials are batched, (C, dim) -> (C,). The Gaussian ones are written
elementwise (no matmul), so a row's value does not depend on how many rows
share the batch. Some runs are shorter than the JAX suite's (noted per test):
the port runs every leaf as a Python step, and tier-1 has a time budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.sample import diagnostics as jdiag
from rgp_tpu.sample import nuts as jnuts
from rgp_tpu_torch.sample import diagnostics as tdiag
from rgp_tpu_torch.sample import nuts as tnuts
from rgp_tpu_torch.sample.hmc import _leapfrog, hmc_sample, step_draws


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test. The test workers share the CPU, and with a thread pool per
    worker a sampler test ran ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss_potential(cov):
    prec = torch.tensor(np.linalg.inv(cov))

    def U(z):
        return 0.5 * (z[:, :, None] * prec * z[:, None, :]).sum((-2, -1))

    return U


def test_hmc_gaussian_moments():
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    res = hmc_sample(_gauss_potential(cov), torch.zeros(2, dtype=torch.float64), 0, n_samples=1200, n_warmup=150,
                     step_size=0.4, n_leapfrog=12, n_chains=4)
    s = res.samples.reshape(-1, 2).numpy()
    assert float(res.accept_prob.mean()) > 0.6
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.3)


def test_nuts_gaussian_moments():
    cov = np.array([[1.0, 0.8, 0.0], [0.8, 1.5, 0.3], [0.0, 0.3, 0.5]])
    res = tnuts.nuts_sample(_gauss_potential(cov), torch.zeros(3, dtype=torch.float64), 1, n_samples=800,
                            n_warmup=400, n_chains=4, max_depth=7)
    s = res.samples.reshape(-1, 3).numpy()
    assert not bool(res.diverging.any())
    assert float(res.accept_prob.mean()) > 0.6
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.35)


def test_nuts_mass_adaptation_scales():
    """Badly scaled Gaussian: the adapted inverse mass tracks the variances.
    150 warmup steps and 300 draws (the JAX suite's 600 and 500): before the
    mass switch every tree runs to ~max_depth, the costly part here."""
    var = np.array([100.0, 0.01])
    res = tnuts.nuts_sample(_gauss_potential(np.diag(var)), torch.zeros(2, dtype=torch.float64), 2,
                            n_samples=300, n_warmup=150, n_chains=2, max_depth=8)
    mi = res.mass_inv.numpy()
    assert mi[0] / mi[1] > 100.0, mi
    s = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.var(0), var, rtol=0.5)


def test_nuts_on_gp_hyperparameters(rng):
    """NUTS over exact-GP hyperparameters through the port's
    gp.log_marginal, vmapped over chains: finite, mixing, few divergences.
    100 warmup steps and 150 draws (the JAX suite's 200 and 200)."""
    from rgp_tpu_torch.kernels import RBF
    from rgp_tpu_torch.models import gp
    from rgp_tpu_torch.params import ravel

    X = torch.tensor(rng.standard_normal((30, 2)))
    Y = torch.sin(X.sum(-1, keepdim=True)) + 0.1 * torch.tensor(rng.standard_normal((30, 1)))
    cfg = gp.GPConfig(RBF(input_dim=2))
    flat0, unravel = ravel(gp.init_params(cfg, noise=0.2, dtype=torch.float64, device="cpu"))

    def potential(v):
        return -(gp.log_marginal(cfg, unravel(v), X, Y) - 0.5 * ((v / 3.0) ** 2).sum())

    res = tnuts.nuts_sample(torch.func.vmap(potential), flat0, 3, n_samples=150, n_warmup=100, n_chains=2,
                            max_depth=6)
    assert np.isfinite(res.samples.numpy()).all()
    assert float(res.accept_prob.mean()) > 0.5
    assert float(res.diverging.double().mean()) < 0.2


# ------------------------------------------------ pure pieces against JAX


def test_is_turning_matches_jax(rng):
    v_l, v_r, r_sum = (rng.standard_normal((64, 3)) for _ in range(3))
    ours = tnuts._is_turning(*(torch.tensor(x) for x in (v_l, v_r, r_sum))).numpy()
    ref = [bool(jnuts._is_turning(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
           for a, b, c in zip(v_l, v_r, r_sum)]
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.sum() < 64


def test_dual_averaging_matches_jax(rng):
    ours = tnuts._da_init(torch.tensor(0.3, dtype=torch.float64))
    ref = jnuts._da_init(jnp.asarray(0.3, jnp.float64))
    for a in rng.uniform(0.0, 1.0, 30):
        ours = tnuts._da_update(ours, torch.tensor(a), 0.8)
        ref = jnuts._da_update(ref, jnp.asarray(a), 0.8)
        for x, y in zip(ours, ref):
            np.testing.assert_allclose(float(x), float(y), rtol=1e-13)


def test_pooled_welford_matches_two_pass(rng):
    """Chan's batch update over steps of C chains' samples equals the two-pass
    mean and sum of squared deviations of every sample seen."""
    batches = [rng.standard_normal((5, 3)) * [1.0, 10.0, 0.1] + 2.0 for _ in range(7)]
    dim = 3
    w = (torch.zeros(dim, dtype=torch.float64), torch.zeros(dim, dtype=torch.float64),
         torch.zeros((), dtype=torch.float64))
    for b in batches:
        w = tnuts._welford_update(w, torch.tensor(b))
    every = np.concatenate(batches)
    np.testing.assert_allclose(w[0].numpy(), every.mean(0), rtol=1e-12)
    np.testing.assert_allclose(w[1].numpy(), ((every - every.mean(0)) ** 2).sum(0), rtol=1e-12)
    assert float(w[2]) == every.shape[0]


def test_median_accept_statistic_matches_jnp_median():
    acc = torch.tensor([0.9, 0.1, 0.5, 0.7], dtype=torch.float64)
    assert float(torch.quantile(acc, 0.5)) == float(jnp.median(jnp.asarray(acc.numpy())))


@pytest.mark.parametrize("chains", [[0.3, 1.0, -2.0], [0.1, 0.1, 0.1]])
def test_diagnostics_array_equal_to_jax(chains):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 200, 3)) + np.asarray(chains)
    np.testing.assert_array_equal(tdiag.split_rhat(x), jdiag.split_rhat(x))
    np.testing.assert_array_equal(tdiag.ess(x), jdiag.ess(x))
    ours, ref = tdiag.summarize(x), jdiag.summarize(x)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_diagnostics_iid_and_correlated():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1000))
    assert abs(float(tdiag.split_rhat(x)) - 1.0) < 0.01
    assert 0.8 * 4000 < float(tdiag.ess(x)) <= 4400
    y = x.copy()
    y[0] += 5.0
    assert float(tdiag.split_rhat(y)) > 1.5


# ------------------------------------------------------- the chain axis


def test_batched_transition_equals_one_chain_transitions():
    """Given the same draws, one transition of C chains equals C
    transitions of one chain, bit for bit: a chain that finishes its tree
    keeps its state while the others go on."""
    cov = np.array([[1.0, 0.8, 0.0], [0.8, 1.5, 0.3], [0.0, 0.3, 0.5]])
    U = _gauss_potential(cov)
    C, dim, max_depth = 4, 3, 6
    z = torch.tensor(np.random.default_rng(1).standard_normal((C, dim)) * 2.0)
    mass_inv = torch.tensor([1.0, 0.7, 1.3], dtype=torch.float64)
    normals, uniforms = step_draws(11, 0, C, 0, dim, 2 * max_depth + 2 ** max_depth, z.dtype, z.device)
    eps = torch.tensor(0.25, dtype=torch.float64)
    batched = tnuts.nuts_transition(U, z, normals, uniforms, eps, mass_inv, max_depth)
    for c in range(C):
        one = tnuts.nuts_transition(U, z[c:c + 1], normals[c:c + 1], uniforms[c:c + 1], eps, mass_inv, max_depth)
        for a, b in zip(batched, one):
            assert torch.equal(a[c:c + 1], b), c
    # the chains stopped at different leaves (else no masking was exercised)

    def leaves_of(c):
        calls = [0]

        def counting(zz):
            calls[0] += 1
            return U(zz)

        tnuts.nuts_transition(counting, z[c:c + 1], normals[c:c + 1], uniforms[c:c + 1], eps, mass_inv, max_depth)
        return calls[0]

    assert len({leaves_of(c) for c in range(C)}) > 1


def test_warmup_is_segmentation_invariant():
    """Warmup 3+3+...+3 equals warmup 24, bit for bit (the window [3, 21)
    and the mass switch at 21 included), and so do the draws after it."""
    U = _gauss_potential(np.diag([4.0, 0.25]))
    z0 = torch.tensor([[0.5, -0.2], [1.0, 0.3], [-0.4, 0.1]], dtype=torch.float64)
    kw = dict(n_warmup=24, max_depth=5, target_accept=0.8)
    one = tnuts.nuts_warmup(U, tnuts.nuts_init(z0, n_chains=3), 5, 24, **kw)
    seg = tnuts.nuts_init(z0, n_chains=3)
    for _ in range(8):
        seg = tnuts.nuts_warmup(U, seg, 5, 3, **kw)
    assert one.step == seg.step == 24
    for a, b in zip([one.zs, *one.da, *one.welford, one.mass_inv], [seg.zs, *seg.da, *seg.welford, seg.mass_inv]):
        assert torch.equal(a, b)
    assert not torch.equal(one.mass_inv, torch.ones(2, dtype=torch.float64))  # the switch ran
    _, r_one = tnuts.nuts_draw(U, one, 5, 4, max_depth=5)
    c2, r_a = tnuts.nuts_draw(U, seg, 5, 2, max_depth=5)
    _, r_b = tnuts.nuts_draw(U, c2, 5, 2, max_depth=5)
    assert torch.equal(r_one.samples, torch.cat([r_a.samples, r_b.samples], 1))


def test_chain_offset_picks_the_chains_draws():
    """Chains 2..3 of a 4-chain batch draw what a 2-chain batch at
    chain_offset=2 draws."""
    n4, u4 = step_draws(7, 3, 4, 0, 5, 6, torch.float64, "cpu")
    n2, u2 = step_draws(7, 3, 2, 2, 5, 6, torch.float64, "cpu")
    assert torch.equal(n4[2:], n2) and torch.equal(u4[2:], u2)


def test_leapfrog_masks_each_chain_at_its_length():
    """A (C,) tensor of trajectory lengths gives each chain the trajectory
    it gets alone at its length."""
    U = _gauss_potential(np.array([[1.0, 0.3], [0.3, 0.5]]))
    rng = np.random.default_rng(2)
    z = torch.tensor(rng.standard_normal((3, 2)))
    r = torch.tensor(rng.standard_normal((3, 2)))
    mass_inv = torch.tensor([1.0, 2.0], dtype=torch.float64)
    n = torch.tensor([1, 4, 2])
    zb, rb, Ub, gb = _leapfrog(U, z, r, 0.1, n, mass_inv)
    for c in range(3):
        zc, rc, Uc, gc = _leapfrog(U, z[c:c + 1], r[c:c + 1], 0.1, int(n[c]), mass_inv)
        for a, b in zip((zb, rb, Ub, gb), (zc, rc, Uc, gc)):
            assert torch.equal(a[c:c + 1], b)
