"""The particle filter (rgp_tpu_torch.sample.smc) and the RGP state-space
model (rgp_tpu_torch.models.rgp_smc) on the CPU.

* smc_filter against the exact Kalman log-likelihood of a scalar linear
  Gaussian state-space model (tests/test_samplers.py's gate);
* systematic resampling: counts within one of N w;
* make_ssm against rgp_tpu.models.rgp_smc.make_ssm in f64 at rtol 1e-10: the
  emission log-density at given particles, and the transition with the
  normals injected (the port is handed the normals JAX drew inside its
  transition), so no random bits are compared;
* api.smc on a small two-layer RGP: finite, ESS bounded by N.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.data import datasets
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu.models import rgp_smc as jsmc
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.models import rgp_smc as tsmc
from rgp_tpu_torch.sample import api as tapi
from rgp_tpu_torch.sample import smc as smc_mod


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test. The test workers share the CPU, and with a thread pool per
    worker a sampler test ran ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lgssm(T=40, a=0.9, q=0.3, r=0.4, seed=0):
    rng = np.random.default_rng(seed)
    x, y = np.zeros(T), np.zeros(T)
    x_prev = 0.0
    for t in range(T):
        x[t] = a * x_prev + q * rng.standard_normal()
        y[t] = x[t] + r * rng.standard_normal()
        x_prev = x[t]
    return x, y


def _kalman_loglik(y, a, q, r):
    """Exact log p(y) for x_t = a x_{t-1} + N(0, q^2), y_t = x_t + N(0, r^2),
    x_1 ~ N(0, q^2)."""
    m, P = 0.0, q**2
    ll = 0.0
    for t in range(len(y)):
        if t > 0:
            m, P = a * m, a**2 * P + q**2
        S = P + r**2
        ll += -0.5 * np.log(2 * np.pi * S) - 0.5 * (y[t] - m) ** 2 / S
        K = P / S
        m, P = m + K * (y[t] - m), (1 - K) * P
    return ll


def test_smc_matches_kalman():
    a, q, r = 0.9, 0.3, 0.4
    _, y = _lgssm(T=40, a=a, q=q, r=r)
    yt = torch.tensor(y)

    def transition_sample(gen, parts, t):
        prev = torch.zeros_like(parts) if t == 0 else parts
        return a * prev + q * torch.randn(parts.shape, generator=gen, dtype=parts.dtype)

    def emission_logpdf(parts, t):
        return -0.5 * np.log(2 * np.pi * r**2) - 0.5 * (yt[t] - parts[:, 0]) ** 2 / r**2

    def init_sample(gen, n):
        return torch.zeros((n, 1), dtype=torch.float64)

    res = smc_mod.smc_filter(transition_sample, emission_logpdf, init_sample, 40, torch.Generator().manual_seed(0),
                             2048)
    exact = _kalman_loglik(y, a, q, r)
    assert abs(float(res.log_marginal) - exact) < 0.5, (float(res.log_marginal), exact)
    assert res.ess_history.shape == (40,) and bool((res.ess_history <= 2048 + 1e-6).all())


def test_systematic_resample_properties():
    log_w = torch.log(torch.tensor([0.5, 0.25, 0.125, 0.125], dtype=torch.float64))
    for seed in range(5):
        idx = smc_mod.systematic_resample(torch.Generator().manual_seed(seed), log_w)
        counts = np.bincount(idx.numpy(), minlength=4)
        assert np.all(np.abs(counts - 4 * np.exp(log_w.numpy())) <= 1)
    assert int(smc_mod.systematic_resample(torch.Generator().manual_seed(0), log_w, 16).shape[0]) == 16


def test_ess_bounds():
    assert float(smc_mod.ess(torch.zeros(8, dtype=torch.float64))) == 8.0
    assert abs(float(smc_mod.ess(torch.tensor([0.0, -1e9, -1e9], dtype=torch.float64))) - 1.0) < 1e-12


@functools.lru_cache(maxsize=1)
def _two_layer_model():
    """An untrained two-hidden-layer RGP (narendra, M=8) from a JAX init
    perturbed by seeded noise, and its carry-over: the state-space view
    needs no trained model to be compared."""
    T = 40
    d = datasets.narendra(T=2 * T, seed=0)
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    data = [jnp.asarray(x, jnp.float64) for x in (sy.transform(d.y_train), su.transform(d.u_train),
                                                  su.transform(d.u_test), sy.transform(d.y_test))]
    kw = dict(wins=[1, 2, 3], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    cfg, tcfg = jr.deep_rgp_config(**kw), tr.deep_rgp_config(**kw)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(np.shape(x)),
                      jr.init_params(cfg, data[0], data[1], dtype=jnp.float64))
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    return cfg, tcfg, jax.tree.map(jnp.asarray, jp), tp, data, [torch.tensor(np.asarray(x)) for x in data]


def test_make_ssm_matches_jax():
    cfg, tcfg, jp, tp, (Y, U, Ut, Yt), (tY, tU, tUt, tYt) = _two_layer_model()
    ref = jsmc.make_ssm(cfg, jp, Y, U, Ut, Yt)
    ours = tsmc.make_ssm(tcfg, tp, tY, tU, tUt, tYt)
    assert (ours.n_steps, ours.state_dim) == (ref.n_steps, ref.state_dim)
    N = 16
    parts = np.asarray(ref.init_sample(jax.random.PRNGKey(0), N))
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    # the normals JAX's transition draws: per particle, per layer, split then normal
    normals = []
    for k in keys:
        row = []
        for spec in cfg.layers:
            k, sub = jax.random.split(k)
            row.append(np.asarray(jax.random.normal(sub, (spec.q_dim,), jnp.float64)))
        normals.append(np.concatenate(row))
    normals = torch.tensor(np.stack(normals))
    emission, transition = jax.jit(ref.emission_logpdf), jax.jit(ref.transition_sample)
    for t in (0, 7):
        np.testing.assert_allclose(ours.emission_logpdf(torch.tensor(parts), t).numpy(),
                                   np.asarray(emission(jnp.asarray(parts), t)), rtol=1e-10)
        np.testing.assert_allclose(ours.transition_from_normals(normals, torch.tensor(parts), t).numpy(),
                                   np.asarray(transition(keys, jnp.asarray(parts), t)), rtol=1e-10)
    # the initial particles: the same trained tail and per-state scale, held
    # as distributions (the packages draw different normals)
    n = 20000
    a = ours.init_sample(torch.Generator().manual_seed(0), n).numpy()
    b = np.asarray(jax.jit(ref.init_sample, static_argnums=1)(jax.random.PRNGKey(0), n))
    sd = b.std(0)
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=float(5 * sd.max() * np.sqrt(2.0 / n)))
    np.testing.assert_allclose(a.std(0), sd, rtol=0.05)


def test_smc_on_rgp():
    _, tcfg, _, tp, _, (tY, tU, tUt, tYt) = _two_layer_model()
    res = tapi.smc(tcfg, tp, tY, tU, tUt, tYt, torch.Generator().manual_seed(0), n_particles=128)
    assert np.isfinite(float(res.log_marginal))
    assert np.isfinite(res.particles.numpy()).all()
    assert bool((res.ess_history <= 128 + 1e-6).all()) and bool((res.ess_history > 0).all())
