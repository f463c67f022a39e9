"""rgp_tpu_torch.inference.natgrad against rgp_tpu.inference.natgrad on the
CPU in float64: SVGP on a 64-row batch of long_corpus(T=800, seed=1)'s NARX
design (y_win=3, u_win=2), M=10, ``T_total`` the whole design.

* ``natgrad_step`` at lr 0.1, 0.5 and 1.0: every leaf of the new q(u) to 1e-8
  of its largest entry, and the ELBO there at rtol 1e-9;
* lr 1 on the conjugate q(u) block jumps to the optimum, the port's own
  collapsed bound, at rtol 1e-6, and a second step stays there at rtol 1e-8
  (tests/test_svi.py's oracle);
* built cases of the guard. From q(u)'s small initial covariance, a step
  beyond lr 1 makes the new precision (1 - lr) S^{-1} + lr P_opt indefinite
  (its raw Cholesky fails): at lr 4 both packages keep lr/4, i.e. the port's
  step at lr 1, bit for bit; at lr 20 every candidate (1.25, 5, 20) fails and
  q(u) is returned unchanged, in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgp_tpu.kernels as jk
from rgp_tpu.data import datasets as jd
from rgp_tpu.data import windows as jw
from rgp_tpu.inference import natgrad as jng
from rgp_tpu.models import svgp as jsvgp
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.inference import natgrad as tng
from rgp_tpu_torch.models import sparse_gp as tsgp
from rgp_tpu_torch.models import svgp as tsvgp

M = 10


@pytest.fixture(scope="module")
def problem():
    d = jd.long_corpus(T=800, seed=1)
    sy, su = jw.Standardizer.fit(d.y_train), jw.Standardizer.fit(d.u_train)
    X, Y = jw.narx_design(sy.transform(d.y_train), su.transform(d.u_train), 3, 2)
    X, Y = np.asarray(X), np.asarray(Y)
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=5), M)
    tcfg = tsvgp.SVGPConfig(tk.RBF(input_dim=5), M)
    rng = np.random.default_rng(5)
    p = jax.tree.map(np.asarray, jsvgp.init_params(cfg, X, noise=0.2, dtype=jnp.float64))
    p["qu"]["m"] = 0.2 * rng.standard_normal((M, 1))
    p["qu"]["tril"] = 0.02 * rng.standard_normal((1, M, M))
    rows = rng.choice(X.shape[0], 64, replace=False)
    Xb, Yb = X[rows], Y[rows]
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_jax(p, dtype=torch.float64, device="cpu")
    T_total = X.shape[0]

    def jelbo(qu, T=T_total):
        return jsvgp.elbo(cfg, {**jp, "qu": qu}, jnp.asarray(Xb), jnp.asarray(Yb), T_total=T)

    def telbo(qu, T=T_total):
        return tsvgp.elbo(tcfg, {**tp, "qu": qu}, torch.tensor(Xb), torch.tensor(Yb), T_total=T)

    return {"jp": jp, "tp": tp, "jelbo": jelbo, "telbo": telbo, "tcfg": tcfg, "Xb": Xb, "Yb": Yb}


def _assert_qu_close(ours, ref, rtol):
    for (path, a), b in zip(train.leaves_with_paths(ours), jax.tree.leaves(ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=rtol * np.abs(b).max(), err_msg=path)


@pytest.mark.parametrize("lr", [0.1, 0.5, 1.0])
def test_natgrad_step_matches_jax(problem, lr):
    ref = jng.natgrad_step(problem["jelbo"], problem["jp"]["qu"], lr)
    ours = tng.natgrad_step(problem["telbo"], problem["tp"]["qu"], lr)
    _assert_qu_close(ours, ref, 1e-8)
    np.testing.assert_allclose(float(problem["telbo"](ours)), float(problem["jelbo"](ref)), rtol=1e-9)
    assert float(problem["telbo"](ours)) > float(problem["telbo"](problem["tp"]["qu"]))


def test_natgrad_lr1_reaches_the_collapsed_bound(problem):
    """Without ``T_total`` the batch is the whole data set of the bound."""
    tp = problem["tp"]

    def elbo(qu):
        return problem["telbo"](qu, T=None)

    qu1 = tng.natgrad_step(elbo, tp["qu"], lr=1.0)
    collapsed = tsgp.elbo(tsgp.SparseGPConfig(problem["tcfg"].kernel, M),
                          {k: tp[k] for k in ("kern", "Z", "log_noise")},
                          torch.tensor(problem["Xb"]), torch.tensor(problem["Yb"]))
    np.testing.assert_allclose(float(elbo(qu1)), float(collapsed), rtol=1e-6)
    qu2 = tng.natgrad_step(elbo, qu1, lr=1.0)
    np.testing.assert_allclose(float(elbo(qu2)), float(elbo(qu1)), rtol=1e-8)


@pytest.mark.parametrize("lr,expect", [(4.0, "lr/4"), (20.0, "no update")])
def test_guard_takes_the_same_smaller_step(problem, lr, expect):
    ref = jng.natgrad_step(problem["jelbo"], problem["jp"]["qu"], lr)
    ours = tng.natgrad_step(problem["telbo"], problem["tp"]["qu"], lr)
    _assert_qu_close(ours, ref, 1e-8)
    want = problem["tp"]["qu"] if expect == "no update" else tng.natgrad_step(problem["telbo"], problem["tp"]["qu"], lr / 4)
    for (path, a), (_, b) in zip(train.leaves_with_paths(ours), train.leaves_with_paths(want)):
        assert torch.equal(a, b), path
    if expect == "lr/4":  # lr/4 is a real step, not the fallback
        assert not torch.equal(ours["m"], problem["tp"]["qu"]["m"])
