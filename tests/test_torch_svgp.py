"""rgp_tpu_torch.models.svgp against rgp_tpu.models.svgp on the CPU in
float64 (long_corpus(T=800, seed=1), NARX windows y_win=3, u_win=2, M=16):

* ``init_params`` array-equal (numpy k-means in both);
* from carried-over, perturbed parameters, ``elbo`` on a 64-row batch with
  ``T_total``, with certain and with uncertain inputs: the value at rtol 1e-9
  and every leaf's gradient to 1e-8 of its largest entry;
* ``predict`` with and without ``Xs_var`` at rtol 1e-9;
* ``freerun_narx`` over 40 test steps, moment-matched and mean-only, at rtol
  1e-7 (two LAPACK builds' rounding, compounded over the loop; the port forms
  the query-independent terms once, the JAX scan every step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgp_tpu.kernels as jk
from rgp_tpu.data import datasets as jd
from rgp_tpu.data import windows as jw
from rgp_tpu.models import svgp as jsvgp
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import svgp as tsvgp

M, Q = 16, 5


@pytest.fixture(scope="module")
def problem():
    d = jd.long_corpus(T=800, seed=1)
    sy, su = jw.Standardizer.fit(d.y_train), jw.Standardizer.fit(d.u_train)
    Y, U, Ut = sy.transform(d.y_train), su.transform(d.u_train), su.transform(d.u_test)[:40]
    X, Yt = (np.asarray(a) for a in jw.narx_design(Y, U, 3, 2))
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=Q), M)
    tcfg = tsvgp.SVGPConfig(tk.RBF(input_dim=Q), M)
    init = jax.tree.map(np.asarray, jsvgp.init_params(cfg, X, noise=0.2, seed=1, dtype=jnp.float64))
    rng = np.random.default_rng(9)
    p = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(np.shape(a)), init)
    p["qu"]["m"] = 0.5 * rng.standard_normal((M, 1))
    p["qu"]["tril"] = 0.05 * rng.standard_normal((1, M, M))
    rows = rng.choice(X.shape[0], 64, replace=False)
    return {"cfg": cfg, "tcfg": tcfg, "init": init, "p": p, "X": X, "Yt": Yt, "rows": rows, "Y": Y, "U": U,
            "Ut": Ut, "X_var": rng.uniform(0.01, 0.2, (64, Q)), "mu_star": rng.standard_normal((6, Q)),
            "s_star": rng.uniform(0.02, 0.3, (6, Q))}


def test_init_params_array_equal(problem):
    ours = tsvgp.init_params(problem["tcfg"], torch.tensor(problem["X"]), noise=0.2, seed=1,
                             dtype=torch.float64, device="cpu")
    ref = jax.tree.leaves(problem["init"])
    named = train.leaves_with_paths(ours)
    assert [p for p, _ in named] == ["Z", "kern/log_ls", "kern/log_var", "log_noise", "qu/log_diag", "qu/m",
                                     "qu/tril"]
    for (path, a), b in zip(named, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


@pytest.mark.parametrize("uncertain", [False, True], ids=["certain", "uncertain"])
def test_elbo_value_and_gradients(problem, uncertain):
    rows = problem["rows"]
    Xb, Yb, T = problem["X"][rows], problem["Yt"][rows], problem["X"].shape[0]
    Xv = problem["X_var"] if uncertain else None
    tp = params_from_jax(problem["p"], dtype=torch.float64, device="cpu")
    named = train.leaves_with_paths(tp)
    leaves = [x.clone().requires_grad_() for _, x in named]
    val = tsvgp.elbo(problem["tcfg"], train.with_leaves(tp, leaves), torch.tensor(Xb), torch.tensor(Yb),
                     X_var=None if Xv is None else torch.tensor(Xv), T_total=T)
    grads = torch.autograd.grad(val, leaves)
    jval, jgrad = jax.value_and_grad(lambda p: jsvgp.elbo(
        problem["cfg"], p, jnp.asarray(Xb), jnp.asarray(Yb), X_var=None if Xv is None else jnp.asarray(Xv),
        T_total=T))(jax.tree.map(jnp.asarray, problem["p"]))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-9)
    for (path, _), g, ref in zip(named, grads, jax.tree.leaves(jgrad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-8 * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize("with_var", [False, True], ids=["certain", "uncertain"])
def test_predict(problem, with_var):
    s = problem["s_star"] if with_var else None
    ref = jsvgp.predict(problem["cfg"], jax.tree.map(jnp.asarray, problem["p"]), jnp.asarray(problem["mu_star"]),
                        Xs_var=None if s is None else jnp.asarray(s))
    tp = params_from_jax(problem["p"], dtype=torch.float64, device="cpu")
    ours = tsvgp.predict(problem["tcfg"], tp, torch.tensor(problem["mu_star"]),
                         Xs_var=None if s is None else torch.tensor(s))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


@pytest.mark.parametrize("moment_match", [True, False])
def test_freerun_narx(problem, moment_match):
    args = (problem["Y"], problem["U"], problem["Ut"])
    ref = jsvgp.freerun_narx(problem["cfg"], jax.tree.map(jnp.asarray, problem["p"]), 3, 2,
                             *(jnp.asarray(a) for a in args), moment_match=moment_match)
    tp = params_from_jax(problem["p"], dtype=torch.float64, device="cpu")
    ours = tsvgp.freerun_narx(problem["tcfg"], tp, 3, 2, *(torch.tensor(a) for a in args),
                              moment_match=moment_match)
    for a, b in zip(ours, ref):
        assert a.shape == (40, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
