"""Particle-sharded SMC and chain-sharded NUTS (rgp_tpu_torch.sample.smc.
smc_filter_sharded, sample.api.smc(mesh=...), sample.api.nuts_sharded) on
ranks spawned over gloo on the CPU, in f64, at world sizes 2 and 4.

The draws are torch's, so the sharded samplers are held against the port's
own single-process ones, which the other sampler tests hold against the JAX
package and the analytic gates:

* ``smc_filter_sharded`` against ``smc_filter`` on the scalar linear Gaussian
  model of tests/test_samplers.py:155-168 (T=30, 512 particles): the
  log-marginal and the particles at rtol 1e-8, the ESS history;
* ``api.smc(..., mesh=)`` against ``api.smc`` on the small trained RGP of
  tests/test_sampling_api.py (64 particles): the log-marginal at rtol 1e-7;
* ``nuts_sharded`` on the 2-D Gaussian of tests/test_sampling_api.py:132 (8
  chains): the step size and mass the same bits on every rank; over a short
  run, the draws equal to ``nuts_sample`` with the same seed and chain count
  at rtol 1e-8; over the JAX test's run (250 warmup steps, 400 draws, depth 6)
  its moment gates.

Every rank returns the same bits. Each world size is one spawn (a module
fixture); the ranks import torch and numpy only.
"""

import functools

import numpy as np
import pytest
import torch

from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.parallel import make_mesh
from rgp_tpu_torch.parallel._launch import spawn_ranks
from rgp_tpu_torch.params import leaves_with_paths, with_leaves
from rgp_tpu_torch.sample import api
from rgp_tpu_torch.sample import smc as smc_mod
from rgp_tpu_torch.sample.nuts import nuts_sample
from rgp_tpu_torch.train import fit_adam

_LG = dict(a=0.9, q=0.3, r=0.4)
_COV = np.array([[1.0, 0.5], [0.5, 1.2]])
_NUTS_SHORT = dict(n_warmup=30, n_samples=10, max_depth=6)
_NUTS_LONG = dict(n_warmup=250, n_samples=400, max_depth=6)
_CHAINS = 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each (see
    tests/test_torch_smc.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lgssm_observations(T=30, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.zeros(T), 0.0
    for t in range(T):
        x = _LG["a"] * x + _LG["q"] * rng.standard_normal()
        y[t] = x + _LG["r"] * rng.standard_normal()
    return torch.tensor(y)


def _lgssm(y):
    """(transition_from_normals, transition_sample, emission_logpdf,
    init_sample) of the scalar model x_t = a x_{t-1} + q e_t, y_t = x_t + r
    n_t."""
    a, q, r = _LG["a"], _LG["q"], _LG["r"]

    def transition_from_normals(normals, parts, t):
        return a * (torch.zeros_like(parts) if t == 0 else parts) + q * normals

    def transition_sample(gen, parts, t):
        return transition_from_normals(torch.randn(parts.shape, generator=gen, dtype=parts.dtype), parts, t)

    def emission_logpdf(parts, t):
        return -0.5 * np.log(2 * np.pi * r**2) - 0.5 * (y[t] - parts[:, 0]) ** 2 / r**2

    def init_sample(gen, n):
        return torch.zeros((n, 1), dtype=torch.float64)

    return transition_from_normals, transition_sample, emission_logpdf, init_sample


def _gauss_potential(z):
    prec = torch.tensor(np.linalg.inv(_COV))
    return 0.5 * (z[:, :, None] * prec * z[:, None, :]).sum((-2, -1))


@functools.lru_cache(maxsize=1)
def _rgp():
    """(cfg keywords, params as numpy, Y, U, U_test, Y_test): the small RGP of
    tests/test_sampling_api.py (narendra T=40, M=8), 50 Adam steps of the
    port's own."""
    d = datasets.standardized_tensors(datasets.narendra(T=80, seed=0), dtype=torch.float64, device="cpu")
    kw = dict(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    cfg = tr.deep_rgp_config(**kw)
    params = tr.init_params(cfg, d.Y, d.U, dtype=torch.float64, device="cpu")
    params = fit_adam(lambda p: -tr.elbo(cfg, p, d.Y, d.U, block=None), params, iters=50,
                      learning_rate=1e-2).params
    leaves = [x.numpy() for _, x in leaves_with_paths(params)]
    return kw, with_leaves(params, leaves), *(x.numpy() for x in (d.Y, d.U, d.U_test, d.Y_test))


def _rgp_tensors(model):
    kw, params_np, *data = model
    params = with_leaves(params_np, [torch.tensor(x) for _, x in leaves_with_paths(params_np)])
    return tr.deep_rgp_config(**kw), params, [torch.tensor(x) for x in data]


def _nuts_result(res):
    return [x.numpy() for x in res]


def _rank_main(rank, model):
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = dist.get_world_size()
    out = {}
    tr_n, _, em, init = _lgssm(_lgssm_observations())
    res = smc_mod.smc_filter_sharded(tr_n, em, init, 30, torch.Generator().manual_seed(7), 512,
                                     make_mesh(particle=world), noise_dim=1)
    out["smc_lgssm"] = [x.numpy() for x in res]

    cfg, params, (Y, U, Ut, Yt) = _rgp_tensors(model)
    res = api.smc(cfg, params, Y, U, Ut, Yt, torch.Generator().manual_seed(3), n_particles=64,
                  mesh=make_mesh(particle=world))
    out["smc_rgp"] = [x.numpy() for x in res]

    z0 = torch.zeros(2, dtype=torch.float64)
    chain_mesh = make_mesh(chain=world)
    for name, kw in (("nuts_short", _NUTS_SHORT), ("nuts_long", _NUTS_LONG)):
        out[name] = _nuts_result(api.nuts_sharded(_gauss_potential, z0, 0, chain_mesh, n_chains=_CHAINS, **kw))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def ranks(request, tmp_path_factory):
    store = tmp_path_factory.mktemp(f"rdv{request.param}") / "store"
    return spawn_ranks(_rank_main, request.param, backend="gloo", init_method=f"file://{store}", args=(_rgp(),),
                       timeout=300.0, pg_timeout=120.0)


def _same_bits(ranks, key):
    for other in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(other[key], ranks[0][key])), key


def test_smc_filter_sharded_matches_single_process(ranks):
    _same_bits(ranks, "smc_lgssm")
    _, tr_s, em, init = _lgssm(_lgssm_observations())
    single = smc_mod.smc_filter(tr_s, em, init, 30, torch.Generator().manual_seed(7), 512)
    log_z, parts, log_w, ess_hist = ranks[0]["smc_lgssm"]
    np.testing.assert_allclose(log_z, single.log_marginal.numpy(), rtol=1e-8)
    np.testing.assert_allclose(parts, single.particles.numpy(), rtol=1e-8)
    np.testing.assert_allclose(log_w, single.log_weights.numpy(), rtol=1e-8)
    np.testing.assert_allclose(ess_hist, single.ess_history.numpy(), rtol=1e-8)
    assert (ess_hist < 0.5 * 512).any(), "the run never resampled"


def test_smc_on_rgp_sharded_matches(ranks):
    _same_bits(ranks, "smc_rgp")
    cfg, params, (Y, U, Ut, Yt) = _rgp_tensors(_rgp())
    single = api.smc(cfg, params, Y, U, Ut, Yt, torch.Generator().manual_seed(3), n_particles=64)
    log_z, parts, _, ess_hist = ranks[0]["smc_rgp"]
    assert np.isfinite(log_z)
    np.testing.assert_allclose(log_z, single.log_marginal.numpy(), rtol=1e-7)
    np.testing.assert_allclose(parts, single.particles.numpy(), rtol=1e-7)
    np.testing.assert_allclose(ess_hist, single.ess_history.numpy(), rtol=1e-7)


def test_nuts_sharded_matches_single_process(ranks):
    _same_bits(ranks, "nuts_short")
    single = nuts_sample(_gauss_potential, torch.zeros(2, dtype=torch.float64), 0, n_chains=_CHAINS, **_NUTS_SHORT)
    ours = ranks[0]["nuts_short"]
    assert ours[0].shape == (_CHAINS, _NUTS_SHORT["n_samples"], 2)
    for a, b in zip(ours, single):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-8)


def test_nuts_sharded_moments(ranks):
    """tests/test_sampling_api.py::test_nuts_sharded_chains's gates; the
    shared step size is one scalar, the same bits on every rank."""
    _same_bits(ranks, "nuts_long")
    samples, *_, step_size, mass_inv = ranks[0]["nuts_long"]
    s = samples.reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), _COV, atol=0.4)
    assert np.ndim(step_size) == 0 and mass_inv.shape == (2,)
