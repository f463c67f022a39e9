"""Config 5's potential and samplers over the RGP hyperparameters:
rgp_tpu_torch.sample.api against rgp_tpu.sample.api on the CPU in f64.

The model is tests/test_sampling_api.py's tiny trained one (narendra, T=40,
M=8, 50 Adam steps in JAX), carried over with ``convert.params_from_jax``.
JAX's potentials are built and jitted once per module (``lru_cache``); JAX's
own samplers are never run here (their compile is what the JAX suite marks
slow), and no random bits are compared across packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu import train as jtrain
from rgp_tpu.data import datasets
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu.sample import api as japi
from rgp_tpu.sample import hmc as jhmc
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.sample import api as tapi
from rgp_tpu_torch.sample import hmc as thmc

# (fixed_whitening, fresh_ladder) routes of make_rgp_potential
ROUTES = [(False, True), (True, True), (False, False), (True, False)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test. The test workers share the CPU, and with a thread pool per
    worker a sampler test ran ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _model():
    T = 40
    d = datasets.narendra(T=2 * T, seed=0)
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    Y = jnp.asarray(sy.transform(d.y_train), jnp.float64)
    U = jnp.asarray(su.transform(d.u_train), jnp.float64)
    cfg = jr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    params = jr.init_params(cfg, Y, U, dtype=jnp.float64)
    params = jtrain.fit_adam(lambda p: -jr.elbo(cfg, p, Y, U, block=None), params, iters=50,
                             learning_rate=1e-2).params
    tcfg = tr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    tp = params_from_jax(jax.tree.map(np.array, params), dtype=torch.float64, device="cpu")
    tY, tU = torch.tensor(np.asarray(Y)), torch.tensor(np.asarray(U))
    return cfg, params, Y, U, tcfg, tp, tY, tU


@functools.lru_cache(maxsize=None)
def _jax_potential(fixed_whitening, fresh_ladder, psi_prefer="scan", block=8):
    cfg, params, Y, U, *_ = _model()
    pot, flat0, _ = japi.make_rgp_potential(cfg, params, Y, U, fixed_whitening=fixed_whitening,
                                            fresh_ladder=fresh_ladder, psi_prefer=psi_prefer, block=block)
    return pot, jax.jit(jax.value_and_grad(pot)), np.asarray(flat0)


def _torch_potential(**kw):
    _, _, _, _, tcfg, tp, tY, tU = _model()
    return tapi.make_rgp_potential(tcfg, tp, tY, tU, **kw)


def _value_and_grad(pot, v):
    x = torch.tensor(v, requires_grad=True)
    u = pot(x)
    return float(u), torch.autograd.grad(u, x)[0].numpy()


def _points(flat0, n, scale=0.05, seed=3):
    rng = np.random.default_rng(seed)
    return flat0[None] + scale * rng.standard_normal((n, flat0.shape[0]))


def test_split_merge_hypers_roundtrip():
    _, _, _, _, _, tp, _, _ = _model()
    hyper = tapi.split_hypers(tp)
    assert sorted(hyper) == ["layers", "out"] and sorted(hyper["layers"][0]) == ["kern", "log_noise"]
    merged = tapi.merge_hypers(tp, hyper)
    assert merged["layers"][0]["Z"] is tp["layers"][0]["Z"]
    assert merged["out"]["kern"] is tp["out"]["kern"]


def test_flat_hypers_match_jax():
    flat0 = _jax_potential(True, True)[2]
    _, tflat0, unravel, _ = _torch_potential()
    np.testing.assert_array_equal(tflat0.numpy(), flat0)
    assert unravel(tflat0)["out"]["log_noise"].shape == ()


@pytest.mark.parametrize("fixed_whitening,fresh_ladder", ROUTES)
def test_potential_matches_jax(fixed_whitening, fresh_ladder):
    """Value and gradient at rtol 1e-9 at the anchor and, where the whitening
    is deterministic, at perturbed points. The fresh laddered whitening runs
    the floor ladder's float32 trial Cholesky each evaluation, whose pass or
    fail at a perturbed point is decided by float32 rounding, which differs
    between the packages (ROADMAP Queue 3, "f32 floor-ladder flips"): it is
    held at the anchor only."""
    _, jvg, flat0 = _jax_potential(fixed_whitening, fresh_ladder)
    pot, _, _, _ = _torch_potential(fixed_whitening=fixed_whitening, fresh_ladder=fresh_ladder, block=8,
                                    psi_prefer="scan")
    laddered_fresh = fresh_ladder and not fixed_whitening
    points = flat0[None] if laddered_fresh else np.concatenate([flat0[None], _points(flat0, 2)])
    for v in points:
        u_ref, g_ref = jvg(jnp.asarray(v))
        u, g = _value_and_grad(pot, v)
        np.testing.assert_allclose(u, float(u_ref), rtol=1e-9)
        g_ref = np.asarray(g_ref)
        np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-9 * np.abs(g_ref).max())


@pytest.mark.parametrize("psi_prefer,fixed_whitening", [("auto", False), ("scan", True)])
def test_batched_potential_equals_chain_loop(psi_prefer, fixed_whitening):
    """The vmapped potential (C, dim) -> (C,) and one autograd.grad of its
    sum give every chain's value and gradient, as a loop over chains does:
    sample_nuts' few-chain route (auto, fresh laddered whitening) and its
    many-chain one (scan, frozen whitening)."""
    pot, flat0, _, batched = _torch_potential(psi_prefer=psi_prefer, fixed_whitening=fixed_whitening, block=8)
    V = torch.tensor(_points(flat0.numpy(), 4, scale=0.02), requires_grad=True)
    U = batched(V)
    (G,) = torch.autograd.grad(U.sum(), V)
    for c in range(4):
        u, g = _value_and_grad(pot, V[c].detach().numpy())
        np.testing.assert_allclose(float(U[c]), u, rtol=1e-12)
        np.testing.assert_allclose(G[c].numpy(), g, rtol=1e-9, atol=1e-9 * np.abs(g).max())


def test_hessian_diagonal_matches_jax():
    """The Hessian goes through the plain path (K2 is differentiable once)."""
    jpot, _, flat0 = _jax_potential(False, True, psi_prefer="auto", block=None)
    ref = np.diag(np.asarray(jax.jit(jax.hessian(jpot))(jnp.asarray(flat0))))
    pot, tflat0, _, _ = _torch_potential(psi_prefer="scan")
    np.testing.assert_allclose(tapi.hessian_diagonal(pot, tflat0).numpy(), ref, rtol=1e-6)


def test_leapfrog_matches_jax():
    """A deterministic trajectory from given (z, r, eps, n_steps, mass):
    the port's batched leapfrog (one chain) against hmc._leapfrog."""
    jpot, _, flat0 = _jax_potential(True, True)
    rng = np.random.default_rng(5)
    z0 = flat0 + 0.02 * rng.standard_normal(flat0.shape)
    r0 = rng.standard_normal(flat0.shape)
    mass_inv = rng.uniform(0.5, 2.0, flat0.shape)
    eps, n_steps = 0.01, 5
    zj, rj = jax.jit(lambda z, r: jhmc._leapfrog(jpot, z, r, eps, n_steps, jnp.asarray(mass_inv)))(
        jnp.asarray(z0), jnp.asarray(r0))
    _, _, _, batched = _torch_potential(fixed_whitening=True, block=8, psi_prefer="scan")
    z, r, _, _ = thmc._leapfrog(batched, torch.tensor(z0)[None], torch.tensor(r0)[None], eps, n_steps,
                                torch.tensor(mass_inv))
    np.testing.assert_allclose(z[0].numpy(), np.asarray(zj), rtol=1e-9)
    np.testing.assert_allclose(r[0].numpy(), np.asarray(rj), rtol=1e-9, atol=1e-9 * np.abs(np.asarray(rj)).max())


def test_fixed_whitening_potential_matches():
    """The frozen-basis potential (the benchmark's) equals the fresh-eigh one
    exactly at the anchor; away from it, the nearby clamp-regularized target
    (~0.2% at a 0.05 perturbation) with a gradient field aligned with the
    fresh one (the analogue of the JAX suite's test of the same name)."""
    pot_ref, flat0, _, _ = _torch_potential()
    pot_fix, _, _, _ = _torch_potential(fixed_whitening=True, psi_prefer="scan", block=8)
    np.testing.assert_allclose(float(pot_fix(flat0)), float(pot_ref(flat0)), rtol=1e-9)
    v = _points(flat0.numpy(), 1, seed=4)[0]
    u_ref, g_ref = _value_and_grad(pot_ref, v)
    u_fix, g_fix = _value_and_grad(pot_fix, v)
    np.testing.assert_allclose(u_fix, u_ref, rtol=1e-2)
    cos = float(g_ref @ g_fix / (np.linalg.norm(g_ref) * np.linalg.norm(g_fix)))
    assert cos > 0.99, cos


def test_sample_nuts_on_rgp():
    _, _, _, _, tcfg, tp, tY, tU = _model()
    res = tapi.sample_nuts(tcfg, tp, tY, tU, 0, n_samples=10, n_warmup=40, n_chains=2, max_depth=4,
                           step_size=0.02)
    s = res.samples.numpy()
    assert np.isfinite(s).all()
    assert float(res.accept_prob.mean()) > 0.4
    assert s.std(axis=(0, 1)).max() > 1e-3  # the chains move


def test_sample_nuts_hessian_precondition_on_rgp():
    """The Hessian-diagonal mass: finite, accepting, moving."""
    _, _, _, _, tcfg, tp, tY, tU = _model()
    res = tapi.sample_nuts(tcfg, tp, tY, tU, 1, n_samples=10, n_warmup=40, n_chains=2, max_depth=4,
                           hessian_precondition=True)
    s = res.samples.numpy()
    assert np.isfinite(s).all()
    assert float(res.accept_prob.mean()) > 0.4
    assert s.std(axis=(0, 1)).max() > 1e-3
    assert bool((res.mass_inv > 0).all())


def test_sample_hmc_on_rgp():
    _, _, _, _, tcfg, tp, tY, tU = _model()
    res = tapi.sample_hmc(tcfg, tp, tY, tU, 0, n_samples=6, n_warmup=2, step_size=0.005, n_leapfrog=5,
                          n_chains=2)
    dim = tapi.make_rgp_potential(tcfg, tp, tY, tU)[1].shape[0]
    assert res.samples.shape == (2, 6, dim) and res.accept_prob.shape == (2, 6)
    assert np.isfinite(res.samples.numpy()).all()

