"""rgp_tpu_torch.inference.svi against rgp_tpu.inference.svi on the CPU in
float64, from the same seeded inputs (long_corpus(T=800, seed=1), NARX
windows y_win=3, u_win=2, M=12, two output columns) and carried-over,
perturbed parameters:

* ``init_qu`` array-equal, ``qu_moments`` at rtol 1e-12;
* ``svi_bound``'s value at rtol 1e-9 and every leaf's gradient to 1e-8 of
  its largest entry, on a batch of 64 rows, with certain inputs and with
  uncertain ones (the plain Psi2 path; the input variances are a leaf too),
  with and without ``T_total`` and ``Y_var``;
* ``svi_predict``'s mean and variance at rtol 1e-9, with and without
  ``s_star``, with and without the noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgp_tpu.kernels as jk
from rgp_tpu.data import datasets as jd
from rgp_tpu.data import windows as jw
from rgp_tpu.inference import svi as jsvi
from rgp_tpu.models import svgp as jsvgp
from rgp_tpu.ops.psi_stats import psi_statistics as jpsi
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.inference import svi as tsvi
from rgp_tpu_torch.ops.psi_stats import psi_statistics as tpsi

M, Q, B = 12, 5, 64


@pytest.fixture(scope="module")
def problem():
    d = jd.long_corpus(T=800, seed=1)
    sy, su = jw.Standardizer.fit(d.y_train), jw.Standardizer.fit(d.u_train)
    X, Yt = jw.narx_design(sy.transform(d.y_train), su.transform(d.u_train), 3, 2)
    X, Yt = np.asarray(X), np.asarray(Yt)
    rng = np.random.default_rng(11)
    Y2 = np.concatenate([Yt, 0.5 * Yt + 0.1 * rng.standard_normal(Yt.shape)], axis=1)
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=Q), M, output_dim=2)
    p = jax.tree.map(np.asarray, jsvgp.init_params(cfg, X, noise=0.2, dtype=jnp.float64))
    p = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(np.shape(a)), p)
    p["qu"]["m"] = 0.5 * rng.standard_normal((M, 2))
    p["qu"]["tril"] = 0.05 * rng.standard_normal((2, M, M))
    rows = rng.choice(X.shape[0], B, replace=False)
    return {"params": p, "X": X[rows], "Y": Y2[rows], "X_var": rng.uniform(0.01, 0.2, (B, Q)),
            "Y_var": rng.uniform(0.0, 0.1, (B, 2)), "T_total": X.shape[0], "mu_star": rng.standard_normal((7, Q)),
            "s_star": rng.uniform(0.02, 0.3, (7, Q))}


def test_init_qu_and_moments(problem):
    ref = jsvi.init_qu(M, 3, init_scale=0.3, dtype=jnp.float64)
    ours = tsvi.init_qu(M, 3, init_scale=0.3, dtype=torch.float64, device="cpu")
    for (path, a), b in zip(train.leaves_with_paths(ours), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
    qu = problem["params"]["qu"]
    tq = params_from_jax(qu, dtype=torch.float64, device="cpu")
    for a, b in zip(tsvi.qu_moments(tq), jsvi.qu_moments(jax.tree.map(jnp.asarray, qu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)


def _bound(lib, kern, tree, Y, T_total, Y_var, uncertain):
    p = tree["params"]
    if lib == "jax":
        stats = jpsi(kern, p["kern"], p["Z"], tree["X"], tree["X_var"] if uncertain else None, block=None)
        return jsvi.svi_bound(kern, p["kern"], p["Z"], p["log_noise"], p["qu"], stats, Y,
                              T_total=T_total, Y_var=Y_var)
    stats = tpsi(kern, p["kern"], p["Z"], tree["X"], tree["X_var"] if uncertain else None, block=None)
    return tsvi.svi_bound(kern, p["kern"], p["Z"], p["log_noise"], p["qu"], stats, Y,
                          T_total=T_total, Y_var=Y_var)


@pytest.mark.parametrize("uncertain", [False, True], ids=["certain", "uncertain"])
@pytest.mark.parametrize("extras", ["plain", "T_total", "T_total_Y_var"])
def test_svi_bound_value_and_gradients(problem, uncertain, extras):
    T_total = problem["T_total"] if extras != "plain" else None
    Y_var = problem["Y_var"] if extras == "T_total_Y_var" else None
    tree = {"params": problem["params"], "X": problem["X"], "X_var": problem["X_var"]}
    tp = params_from_jax(tree, dtype=torch.float64, device="cpu")
    named = train.leaves_with_paths(tp)
    leaves = [x.clone().requires_grad_() for _, x in named]
    t_y, t_yv = torch.tensor(problem["Y"]), None if Y_var is None else torch.tensor(Y_var)
    val = _bound("torch", tk.RBF(input_dim=Q), train.with_leaves(tp, leaves), t_y, T_total, t_yv, uncertain)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    jtree = jax.tree.map(jnp.asarray, tree)
    jval, jgrad = jax.value_and_grad(
        lambda t: _bound("jax", jk.RBF(input_dim=Q), t, jnp.asarray(problem["Y"]), T_total,
                         None if Y_var is None else jnp.asarray(Y_var), uncertain))(jtree)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-9)
    for (path, _), g, ref in zip(named, grads, jax.tree.leaves(jgrad)):
        ref = np.asarray(ref)
        if g is None:  # X_var with certain inputs
            assert not uncertain and path == "X_var" and not ref.any()
            continue
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-8 * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize("with_s", [False, True], ids=["certain", "uncertain"])
@pytest.mark.parametrize("include_noise", [False, True])
def test_svi_predict(problem, with_s, include_noise):
    p = problem["params"]
    s = problem["s_star"] if with_s else None
    kern_j, kern_t = jk.RBF(input_dim=Q), tk.RBF(input_dim=Q)
    jp = jax.tree.map(jnp.asarray, p)
    ref = jsvi.svi_predict(kern_j, jp["kern"], jp["Z"], jp["log_noise"], jp["qu"],
                           jnp.asarray(problem["mu_star"]), None if s is None else jnp.asarray(s),
                           include_noise=include_noise)
    tp = params_from_jax(p, dtype=torch.float64, device="cpu")
    ours = tsvi.svi_predict(kern_t, tp["kern"], tp["Z"], tp["log_noise"], tp["qu"],
                            torch.tensor(problem["mu_star"]), None if s is None else torch.tensor(s),
                            include_noise=include_noise)
    for a, b in zip(ours, ref):
        assert a.shape == (7, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)
