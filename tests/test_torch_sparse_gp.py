"""Config 3's modules against the JAX package on the CPU in float64:
narx_design, sparse_gp, gp and gp_narx, and collapsed_vi's predictive
summaries.

* narx_design (torch and numpy) is array-equal to rgp_tpu's;
* sparse_gp.init_params and gp_narx.init_params are array-equal (numpy
  k-means in both);
* from carried-over, perturbed parameters: sparse_gp.elbo, gp.log_marginal
  and gp_narx.elbo and every leaf's gradient at rtol 1e-8, and predictions;
* gp_narx.freerun over 32 steps, RBF moment-matched and Matern-5/2 mean-only,
  at rtol 1e-7 (two LAPACK builds' rounding, compounded over the loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgp_tpu.kernels as jk
from rgp_tpu.data import datasets as jd
from rgp_tpu.data import windows as jw
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.inference import collapsed_vi as jcvi
from rgp_tpu.models import gp as jgp
from rgp_tpu.models import gp_narx as jnarx
from rgp_tpu.models import sparse_gp as jsgp
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.data import windows as tw
from rgp_tpu_torch.inference import collapsed_vi as tcvi
from rgp_tpu_torch.models import gp as tgp
from rgp_tpu_torch.models import gp_narx as tnarx
from rgp_tpu_torch.models import sparse_gp as tsgp

KERNELS = {"rbf": lambda K: K.RBF(input_dim=15), "matern52": lambda K: K.Matern52(input_dim=15)}


def _actuator(T=160):
    d = jd.actuator()
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    return (sy.transform(d.y_train)[:T], su.transform(d.u_train)[:T],
            su.transform(d.u_test)[:40])


def _perturb(tree, rng, scale=0.1):
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)), tree)


def _grads_match(torch_loss, jax_loss, tree, rtol):
    """torch_loss(torch tree) and jax_loss(jax tree) from the numpy ``tree``:
    values at rtol, every leaf's gradient to rtol of its largest entry."""
    tp = params_from_jax(tree, dtype=torch.float64, device="cpu")
    named = train.leaves_with_paths(tp)
    leaves = [x.clone().requires_grad_() for _, x in named]
    val = torch_loss(train.with_leaves(tp, leaves))
    grads = torch.autograd.grad(val, leaves)
    jval, jgrad = jax.jit(jax.value_and_grad(jax_loss))(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=rtol)
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(jleaves) == len(grads)
    for (path, _), g, ref in zip(named, grads, jleaves):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize("y_win,u_win,with_u", [(3, 2, True), (2, 4, True), (2, 1, True), (3, 0, True),
                                                 (2, 0, False), (0, 3, True)])
def test_narx_design_array_equal(y_win, u_win, with_u, rng):
    Y, U = rng.standard_normal((12, 2)), rng.standard_normal((12, 3))
    Uarg = U if with_u else None
    ref = jw.narx_design(Y, Uarg, y_win, u_win)
    ours = tw.narx_design(torch.tensor(Y), None if Uarg is None else torch.tensor(U), y_win, u_win)
    host = tw.np_narx_design(Y, Uarg, y_win, u_win)
    for a, b, c in zip(ours, host, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(c))
    with pytest.raises(ValueError):
        tw.narx_design(torch.tensor(Y), None, 0, 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kern", sorted(KERNELS))
def test_init_params_array_equal(kern, dtype):
    Y, U, _ = _actuator()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jnarx.NARXConfig(KERNELS[kern](jk), num_inducing=20, y_win=10, u_win=5)
    tcfg = tnarx.NARXConfig(KERNELS[kern](tk), num_inducing=20, y_win=10, u_win=5)
    ref = jnarx.init_params(jcfg, jnp.asarray(Y, jdt), jnp.asarray(U, jdt), seed=3, dtype=jdt)
    ours = tnarx.init_params(tcfg, torch.tensor(Y, dtype=tdt), torch.tensor(U, dtype=tdt), seed=3, dtype=tdt,
                             device="cpu")
    X = jw.narx_design(Y, U, 10, 5)[0]
    ref_s = jsgp.init_params(jcfg.sparse, X, noise=0.3, seed=1, dtype=jdt)
    ours_s = tsgp.init_params(tcfg.sparse, torch.tensor(np.asarray(X)), noise=0.3, seed=1, dtype=tdt,
                              device="cpu")
    for o, r in ((ours, ref), (ours_s, ref_s)):
        a = [x.numpy() for _, x in train.leaves_with_paths(o)]
        b = [np.asarray(x) for x in jax.tree_util.tree_leaves(r)]
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module", params=sorted(KERNELS))
def narx(request):
    """GP-NARX at M=16 on 160 actuator steps: JAX init perturbed by seeded
    numpy noise, both configs, and the data."""
    Y, U, Ut = _actuator()
    jcfg = jnarx.NARXConfig(KERNELS[request.param](jk), num_inducing=16, y_win=10, u_win=5)
    tcfg = tnarx.NARXConfig(KERNELS[request.param](tk), num_inducing=16, y_win=10, u_win=5)
    jp = _perturb(jnarx.init_params(jcfg, jnp.asarray(Y), jnp.asarray(U), dtype=jnp.float64),
                  np.random.default_rng(5))
    return request.param, jcfg, tcfg, jp, (Y, U, Ut)


def test_gp_narx_elbo_and_grads_match_jax(narx):
    _, jcfg, tcfg, jp, (Y, U, _) = narx
    tY, tU = torch.tensor(Y), torch.tensor(U)
    _grads_match(lambda p: tnarx.elbo(tcfg, p, tY, tU),
                 lambda p: jnarx.elbo(jcfg, p, jnp.asarray(Y), jnp.asarray(U)), jp, 1e-8)


def test_sparse_gp_elbo_grads_and_predict_match_jax(narx):
    _, jcfg, tcfg, jp, (Y, U, _) = narx
    X, Yt = (np.asarray(a) for a in jw.narx_design(Y, U, 10, 5))
    tX, tYt = torch.tensor(X), torch.tensor(Yt)
    _grads_match(lambda p: tsgp.elbo(tcfg.sparse, p, tX, tYt),
                 lambda p: jsgp.elbo(jcfg.sparse, p, jnp.asarray(X), jnp.asarray(Yt)), jp, 1e-8)
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    jpp = jax.tree.map(jnp.asarray, jp)
    for full_cov in (False, True):
        ours = tsgp.predict(tcfg.sparse, tp, tX, tYt, tX[:12], full_cov=full_cov)
        ref = jsgp.predict(jcfg.sparse, jpp, jnp.asarray(X), jnp.asarray(Yt), jnp.asarray(X[:12]),
                           full_cov=full_cov)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)
    draws = tsgp.posterior_samples_f(tcfg.sparse, tp, tX, tYt, tX[:12], torch.Generator().manual_seed(0),
                                     n_samples=3)
    assert draws.shape == (3, 12, 1) and bool(torch.isfinite(draws).all())


def test_gp_narx_freerun_matches_jax(narx):
    """RBF: moment-matched; Matern-5/2: means only (no closed form), as the
    harness runs them."""
    kern, jcfg, tcfg, jp, (Y, U, Ut) = narx
    mm = kern == "rbf"
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    ours = tnarx.freerun(tcfg, tp, torch.tensor(Y), torch.tensor(U), torch.tensor(Ut[:32]),
                         y_init=torch.tensor(Y[-10:]), moment_match=mm)
    ref = jnarx.freerun(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(Y), jnp.asarray(U),
                        jnp.asarray(Ut[:32]), y_init=jnp.asarray(Y[-10:]), moment_match=mm)
    for a, b in zip(ours, ref):
        assert a.shape == (32, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


@pytest.mark.parametrize("kern", ["rbf", "matern32"])
def test_gp_log_marginal_grads_and_predict_match_jax(kern, rng):
    build = {"rbf": lambda K: K.RBF(input_dim=3), "matern32": lambda K: K.Matern32(input_dim=3)}[kern]
    X, Y, Xs = rng.standard_normal((30, 3)), rng.standard_normal((30, 2)), rng.standard_normal((7, 3))
    jcfg, tcfg = jgp.GPConfig(build(jk)), tgp.GPConfig(build(tk))
    jp = _perturb(jgp.init_params(jcfg, noise=0.3, dtype=jnp.float64), rng)
    _grads_match(lambda p: tgp.log_marginal(tcfg, p, torch.tensor(X), torch.tensor(Y)),
                 lambda p: jgp.log_marginal(jcfg, p, jnp.asarray(X), jnp.asarray(Y)), jp, 1e-8)
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    for full_cov in (False, True):
        ours = tgp.predict(tcfg, tp, torch.tensor(X), torch.tensor(Y), torch.tensor(Xs), full_cov=full_cov)
        ref = jgp.predict(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs),
                          full_cov=full_cov)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(float(tgp.neg_log_marginal(tcfg, tp, torch.tensor(X), torch.tensor(Y))),
                               -float(jgp.log_marginal(jcfg, jax.tree.map(jnp.asarray, jp), X, Y)), rtol=1e-8)


def test_predictive_summaries_match_jax(rng):
    y, m, v = rng.standard_normal((9, 2)), rng.standard_normal((9, 2)), rng.uniform(0.1, 2.0, (9, 2))
    np.testing.assert_allclose(float(tcvi.log_predictive_density(*map(torch.tensor, (y, m, v)))),
                               float(jcvi.log_predictive_density(y, m, v)), rtol=1e-12)
    for a, b in zip(tcvi.predict_quantiles(torch.tensor(m), torch.tensor(v), (5.0, 50.0, 97.5)),
                    jcvi.predict_quantiles(jnp.asarray(m), jnp.asarray(v), (5.0, 50.0, 97.5))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
