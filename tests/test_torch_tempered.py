"""Tempered SMC (rgp_tpu_torch.sample.tempered) and sample_tempered
(rgp_tpu_torch.sample.api) against rgp_tpu on the CPU in f64.

* the helpers (_ess_from_logw, _incr_logw, _sanitize_logL, _next_beta) on
  seeded log-likelihoods with -inf and NaN entries, at rtol 1e-12;
* a whole run on tests/test_samplers.py's conjugate Gaussian, fed through the
  seam with JAX's own draws (rebuilt with jax.random from the reference's
  keys), at rtol 1e-10;
* the reference's two gates on the port's own generator: the analytic
  evidence at N=4096 and the truncation report at max_stages=3;
* the vmapped tempered log-likelihood against jax.vmap of the reference's at
  16 particles of test_torch_sample_api.py's tiny trained model, for an RBF
  and a Sum(RBF, Linear) config, and against a loop of single evaluations;
* sample_tempered on that model under the reference's gate
  (tests/test_sampling_api.py::test_sample_tempered_on_rgp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from rgp_tpu import train as jtrain
from rgp_tpu.data import datasets
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.inference.collapsed_vi import Whitening as JWhitening
from rgp_tpu.kernels import RBF as JRBF
from rgp_tpu.kernels import Linear as JLinear
from rgp_tpu.kernels import Sum as JSum
from rgp_tpu.models import rgp as jr
from rgp_tpu.params import ravel as jravel
from rgp_tpu.sample import api as japi
from rgp_tpu.sample import tempered as jt
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.inference.collapsed_vi import default_spectral_floor
from rgp_tpu_torch.kernels import RBF as TRBF
from rgp_tpu_torch.kernels import Linear as TLinear
from rgp_tpu_torch.kernels import Sum as TSum
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.sample import api as tapi
from rgp_tpu_torch.sample import tempered as tt


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test (the test workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logL(seed, n=64):
    """Seeded log-likelihoods with -inf, +inf and NaN entries."""
    rng = np.random.default_rng(seed)
    x = -np.abs(rng.standard_normal(n)) * 10.0 ** rng.uniform(0, 3, n)
    x[rng.choice(n, 6, replace=False)] = [-np.inf, -np.inf, np.nan, np.inf, np.nan, -np.inf]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helpers_match_jax(seed):
    raw = _logL(seed)
    logL = np.asarray(jt._sanitize_logL(jnp.asarray(raw)))
    ours = tt._sanitize_logL(torch.tensor(raw)).numpy()
    np.testing.assert_array_equal(ours, logL)
    assert np.isneginf(ours).sum() == 6
    for db in (0.0, 1e-4, 0.3, 1.0):
        ref = np.asarray(jt._incr_logw(db, jnp.asarray(logL)))
        got = tt._incr_logw(torch.tensor(db, dtype=torch.float64), torch.tensor(logL)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        assert not np.isnan(got).any()  # 0 * (-inf) stays -inf
        np.testing.assert_allclose(float(tt._ess_from_logw(torch.tensor(ref))),
                                   float(jt._ess_from_logw(jnp.asarray(ref))), rtol=1e-12)
    for beta in (0.0, 0.01, 0.5):
        for target in (0.3, 0.5, 0.9):
            ref = float(jt._next_beta(jnp.asarray(beta), jnp.asarray(logL), 64, target))
            got = float(tt._next_beta(torch.tensor(beta, dtype=torch.float64), torch.tensor(logL), 64, target))
            np.testing.assert_allclose(got, ref, rtol=1e-12)
    # a flat likelihood keeps every ESS: straight to beta = 1
    flat = torch.full((8,), -3.0, dtype=torch.float64)
    assert float(tt._next_beta(torch.tensor(0.2, dtype=torch.float64), flat, 8, 0.5)) == 1.0


def _conjugate(rng, D=2, n_obs=10, sigma=0.7):
    """tests/test_samplers.py's conjugate Gaussian: prior N(0, I), y_i ~
    N(theta, sigma^2 I). Returns the data, JAX's single-vector callables and
    the port's batched ones."""
    y = rng.standard_normal((n_obs, D)) * 0.9 + 0.4
    yj, yt = jnp.asarray(y), torch.tensor(y)

    def jprior(th):
        return -0.5 * jnp.sum(th * th) - 0.5 * D * jnp.log(2 * jnp.pi)

    def jlik(th):
        return jnp.sum(-0.5 * ((yj - th) / sigma) ** 2 - 0.5 * jnp.log(2 * jnp.pi * sigma**2))

    def tprior(V):
        return -0.5 * (V * V).sum(-1) - 0.5 * D * np.log(2 * np.pi)

    def tlik(V):
        return (-0.5 * ((yt[None] - V[:, None, :]) / sigma) ** 2 - 0.5 * np.log(2 * np.pi * sigma**2)).sum((1, 2))

    return y, (jprior, jlik), (tprior, tlik)


def _jax_draws(key, N, D, n_moves):
    """The reference's draws from ``key``: init particles, then per stage
    (the resample uniform, per move (normals, uniforms)), by split, then
    fold_in(stage), split, fold_in(move), split."""
    k_init, k_loop = jax.random.split(key)
    parts0 = np.asarray(jax.random.normal(k_init, (N, D), jnp.float64))

    def stage_draws(stage):
        k_res, k_mh = jax.random.split(jax.random.fold_in(k_loop, stage))
        u0 = torch.tensor(float(jax.random.uniform(k_res, (), jnp.float64)), dtype=torch.float64)
        moves = []
        for i in range(n_moves):
            k_prop, k_u = jax.random.split(jax.random.fold_in(k_mh, i))
            moves.append((torch.tensor(np.asarray(jax.random.normal(k_prop, (N, D), jnp.float64))),
                          torch.tensor(np.asarray(jax.random.uniform(k_u, (N,), jnp.float64)))))
        return u0, moves

    return torch.tensor(parts0), stage_draws


def test_smc_tempered_matches_jax_with_its_draws(rng):
    N, D, kw = 256, 2, dict(ess_target=0.6, n_moves=4, step_scale=0.6, max_stages=50)
    _, (jprior, jlik), (tprior, tlik) = _conjugate(rng, D)
    key = jax.random.PRNGKey(0)
    ref = jt.smc_tempered(jprior, jlik, lambda k, n: jax.random.normal(k, (n, D), jnp.float64), key, N, **kw)
    parts0, draws = _jax_draws(key, N, D, kw["n_moves"])
    got = tt._smc_tempered(tprior, tlik, parts0, draws, max_stages=kw["max_stages"], ess_target=kw["ess_target"],
                           step_scale=kw["step_scale"])
    assert got.n_stages == int(ref.n_stages) and got.n_stages > 2
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(ref.particles), rtol=1e-10)
    np.testing.assert_allclose(float(got.log_Z), float(ref.log_Z), rtol=1e-10)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(ref.betas), rtol=1e-10)
    np.testing.assert_allclose(float(got.accept_rate), float(ref.accept_rate), rtol=1e-10)
    np.testing.assert_allclose(float(got.beta_final), float(ref.beta_final), rtol=1e-10)


def test_smc_tempered_conjugate_gaussian_evidence(rng):
    """The reference's gate on the port's own generator: log Z against the
    analytic evidence, the particles against the analytic posterior."""
    D, n_obs, sigma = 2, 10, 0.7
    y, _, (tprior, tlik) = _conjugate(rng, D, n_obs, sigma)
    res = tt.smc_tempered(tprior, tlik, lambda g, n: torch.randn((n, D), generator=g, dtype=torch.float64),
                          torch.Generator().manual_seed(0), 4096, ess_target=0.6, n_moves=4, step_scale=0.6)
    cov = sigma**2 * np.eye(n_obs) + np.ones((n_obs, n_obs))
    logZ_true = sum(scipy.stats.multivariate_normal(mean=np.zeros(n_obs), cov=cov).logpdf(y[:, d])
                    for d in range(D))
    assert np.isfinite(float(res.log_Z))
    np.testing.assert_allclose(float(res.log_Z), logZ_true, atol=0.15)
    tau2 = 1.0 / (1.0 + n_obs / sigma**2)
    parts = res.particles.numpy()
    np.testing.assert_allclose(parts.mean(0), tau2 * y.sum(0) / sigma**2, atol=0.02)
    np.testing.assert_allclose(parts.var(0), tau2, rtol=0.25)
    assert 1 <= res.n_stages <= 50
    betas = res.betas.numpy()[:res.n_stages]
    assert betas[-1] == 1.0 and np.all(np.diff(np.concatenate([[0.0], betas])) > 0)
    assert 0.1 < float(res.accept_rate) <= 1.0


def test_smc_tempered_reports_truncation():
    res = tt.smc_tempered(lambda V: -0.5 * (V * V).sum(-1), lambda V: -5000.0 * ((V - 3.0) ** 2).sum(-1),
                          lambda g, n: torch.randn((n, 2), generator=g, dtype=torch.float64),
                          torch.Generator().manual_seed(0), 128, max_stages=3)
    assert res.n_stages == 3 and float(res.beta_final) < 1.0


# ------------------------------------------------------------ RGP hypers


@functools.lru_cache(maxsize=None)
def _model(kernel: str):
    """test_torch_sample_api.py's tiny trained model (narendra, T=40, M=8, 50
    Adam steps in JAX), with an RBF or a Sum(RBF, Linear) hidden layer."""
    T = 40
    d = datasets.narendra(T=2 * T, seed=0)
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    Y = jnp.asarray(sy.transform(d.y_train), jnp.float64)
    U = jnp.asarray(su.transform(d.u_train), jnp.float64)
    kw = dict(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    din = 2 + 2
    jk = tk = None
    if kernel == "sum":
        jk = [JSum(input_dim=din, parts=(JRBF(input_dim=din), JLinear(input_dim=din)))]
        tk = [TSum(input_dim=din, parts=(TRBF(input_dim=din), TLinear(input_dim=din)))]
    cfg = jr.deep_rgp_config(**kw, kernels=jk)
    params = jr.init_params(cfg, Y, U, dtype=jnp.float64)
    params = jtrain.fit_adam(lambda p: -jr.elbo(cfg, p, Y, U, block=None), params, iters=50,
                             learning_rate=1e-2).params
    tcfg = tr.deep_rgp_config(**kw, kernels=tk)
    tp = params_from_jax(jax.tree.map(np.array, params), dtype=torch.float64, device="cpu")
    return cfg, params, Y, U, tcfg, tp, torch.tensor(np.asarray(Y)), torch.tensor(np.asarray(U))


def _rungs(whitenings):
    """Each whitening's floor-ladder rung (0, 1, 2 for the spectral floor
    times 1, 1e3, 1e6), read off its basis: where the floor clamps the
    spectrum, lambda_eff's smallest over its largest is the floor; -1 where
    it clamps nothing."""
    floor = default_spectral_floor(np.float64)
    rungs = []
    for w in whitenings:
        W, topup = np.asarray(w.W), np.asarray(w.topup)
        lam_eff = 1.0 / (W * W).sum(0)
        rung = int(np.round(np.log10(lam_eff.min() / lam_eff.max() / floor) / 3.0))
        rungs.append(rung if (topup > 0).any() else -1)
    return rungs


@pytest.mark.parametrize("kernel", ["rbf", "sum"])
def test_tempered_loglik_matches_jax(kernel):
    """sample_tempered's log-likelihood, rgp.elbo(block=None) with the default
    jitter and a fresh laddered whitening, batched over 16 particles near the
    fit, against jax.vmap of the reference's at rtol 1e-10.

    The ladder's float32 trial Cholesky passes or fails by float32 rounding,
    which differs between the packages (ROADMAP.md Queue 3): at a particle
    where the two pick different rungs, the port's value is held at rtol
    1e-10 against the reference's bound at the port's basis instead, and the
    flip must be one of the ladder's rungs."""
    cfg, params, Y, U, tcfg, tp, tY, tU = _model(kernel)
    flat0, unravel = jravel(japi.split_hypers(params))

    def jparams(v):
        return japi.merge_hypers(params, unravel(v))

    rng = np.random.default_rng(7)
    V = np.asarray(flat0)[None] + 0.05 * rng.standard_normal((16, flat0.shape[0]))
    ref = np.asarray(jax.jit(jax.vmap(lambda v: jr.elbo(cfg, jparams(v), Y, U, block=None)))(jnp.asarray(V)))
    loglik, tflat0, tunravel = tapi.make_rgp_loglik(tcfg, tp, tY, tU)
    np.testing.assert_array_equal(tflat0.numpy(), np.asarray(flat0))
    got = loglik(torch.tensor(V))
    assert got.shape == (16,) and not got.requires_grad
    flips = 0
    for i, v in enumerate(V):
        j_wh = jr.compute_whitenings(cfg, jparams(jnp.asarray(v)), Y, U, block=None)
        with torch.no_grad():
            t_wh = tr.compute_whitenings(tcfg, tapi.merge_hypers(tp, tunravel(torch.tensor(v))), tY, tU, block=None)
        j_rungs, t_rungs = _rungs(j_wh), _rungs(t_wh)
        if j_rungs == t_rungs:
            np.testing.assert_allclose(float(got[i]), ref[i], rtol=1e-10)
            continue
        flips += 1
        assert set(j_rungs + t_rungs) <= {-1, 0, 1, 2}, (j_rungs, t_rungs)
        at_ours = jr.elbo(cfg, jparams(jnp.asarray(v)), Y, U, block=None,
                          whitening=tuple(JWhitening(*(jnp.asarray(x.numpy()) for x in w)) for w in t_wh))
        np.testing.assert_allclose(float(got[i]), float(at_ours), rtol=1e-10)
    assert flips <= 4, f"{flips} of 16 particles took another ladder rung than the reference"
    loop = torch.stack([loglik(torch.tensor(v)[None])[0] for v in V])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=1e-12)


def test_sample_tempered_on_rgp():
    """The reference's gate: finite evidence, 1 <= stages <= 20, finite
    particles, and the ELBO at the particle mean no more than 50 nats below
    the fit's."""
    _, _, _, _, tcfg, tp, tY, tU = _model("rbf")
    res, unravel = tapi.sample_tempered(tcfg, tp, tY, tU, torch.Generator().manual_seed(0), n_particles=64,
                                        prior_std=0.5, n_moves=2, max_stages=20)
    assert np.isfinite(float(res.log_Z))
    assert 1 <= res.n_stages <= 20
    parts = res.particles
    assert bool(torch.isfinite(parts).all())
    with torch.no_grad():
        e_fit = float(tr.elbo(tcfg, tp, tY, tU, block=None))
        e_mean = float(tr.elbo(tcfg, tapi.merge_hypers(tp, unravel(parts.mean(0))), tY, tU, block=None))
    assert e_mean > e_fit - 50.0, (e_mean, e_fit)
