"""rgp_tpu_torch.ops.psi_stats against rgp_tpu.ops.psi_stats on the CPU in
float64, for the kernels beyond RBF: Linear, Bias, White, a disjoint Prod, the
Sum cases of tests/test_psi_stats.py (cross terms RBF x Linear, RBF x RBF,
Linear x Linear, Bias x any) and a kernel with no closed form on certain
inputs.

Psi0, Psi1, the summed Psi2 (chunked and whole) and the per-t Psi2 from the
same seeded inputs and perturbed hyperparameters at rtol 1e-9; the gradient
of a random linear functional of all four with respect to the hyperparameters,
Z, mu and log s, each to 1e-9 of its largest entry. An RBF part of a Sum goes
through ``_rbf_psi2_sum``, the route to the CUDA kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgp_tpu.kernels as jk
import rgp_tpu.ops.psi_stats as jps
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.ops import psi_stats as tps

CASES = {
    "linear": lambda K: K.Linear(input_dim=3),
    "linear_active": lambda K: K.Linear(input_dim=2, active_dims=(0, 2)),
    "bias": lambda K: K.Bias(input_dim=3),
    "white": lambda K: K.White(input_dim=3),
    "prod_disjoint": lambda K: K.RBF(input_dim=2, active_dims=(0, 1)) * K.Linear(input_dim=1, active_dims=(2,)),
    "prod_disjoint_rbf": lambda K: K.Prod(input_dim=3, parts=(K.RBF(input_dim=1, active_dims=(2,)),
                                                              K.RBF(input_dim=2, active_dims=(0, 1)))),
    # tests/test_psi_stats.py:36-41
    "sum_rbf_white_bias": lambda K: K.Sum(input_dim=3, parts=(K.RBF(input_dim=3), K.White(input_dim=3),
                                                              K.Bias(input_dim=3))),
    "sum_linear_bias": lambda K: K.Sum(input_dim=3, parts=(K.Linear(input_dim=3), K.Bias(input_dim=3))),
    # tests/test_psi_stats.py:114-133
    "sum_rbf_linear": lambda K: K.Sum(input_dim=3, parts=(K.RBF(input_dim=3), K.Linear(input_dim=3))),
    "sum_rbf_linear_active": lambda K: K.Sum(
        input_dim=3, parts=(K.RBF(input_dim=2, active_dims=(0, 1)), K.Linear(input_dim=2, active_dims=(1, 2)))),
    "sum_rbf_rbf": lambda K: K.Sum(
        input_dim=3, parts=(K.RBF(input_dim=2, active_dims=(0, 1)), K.RBF(input_dim=3, ard=False))),
    "sum_linear_linear": lambda K: K.Sum(
        input_dim=3, parts=(K.Linear(input_dim=2, active_dims=(1, 2)), K.Linear(input_dim=3))),
    "sum_rbf_linear_bias": lambda K: K.Sum(input_dim=3, parts=(K.RBF(input_dim=3), K.Linear(input_dim=3),
                                                               K.Bias(input_dim=3))),
}
RBF_PARTS = {"prod_disjoint": 0, "prod_disjoint_rbf": 0, "sum_rbf_white_bias": 1, "sum_rbf_linear": 1,
             "sum_rbf_linear_active": 1, "sum_rbf_rbf": 2, "sum_rbf_linear_bias": 1}


def _inputs(rng, T=20, M=4, Q=3):
    return {"Z": rng.standard_normal((M, Q)), "mu": rng.standard_normal((T, Q)),
            "log_s": np.log(rng.uniform(0.05, 0.5, (T, Q)))}


def _functional(mod, kern, a, W, block, certain=False):
    s = None if certain else (jnp.exp(a["log_s"]) if mod is jps else torch.exp(a["log_s"]))
    st = mod.psi_statistics(kern, a["p"], a["Z"], a["mu"], s, block=block)
    p2t = mod.psi2_per_t(kern, a["p"], a["Z"], a["mu"], s)
    return [st.psi0, st.psi1, st.psi2, p2t], sum((x * w).sum() for x, w in zip((st.psi0, st.psi1, st.psi2, p2t), W))


def _check(build, rng, block, certain=False):
    jkern, tkern = build(jk), build(tk)
    jp = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(-0.4, 0.4, np.shape(a)),
                      jkern.init(dtype=jnp.float64))
    inputs = _inputs(rng)
    T, M = inputs["mu"].shape[0], inputs["Z"].shape[0]
    W = [rng.standard_normal(shape) for shape in ((T,), (T, M), (M, M), (T, M, M))]
    jargs = {"p": jax.tree.map(jnp.asarray, jp), **{k: jnp.asarray(v) for k, v in inputs.items()}}
    targs = {"p": params_from_jax(jp, dtype=torch.float64, device="cpu"),
             **{k: torch.tensor(v) for k, v in inputs.items()}}

    jW, tW = [jnp.asarray(w) for w in W], [torch.tensor(w) for w in W]
    jf = jax.jit(lambda a: _functional(jps, jkern, a, jW, block, certain))
    jvals, _ = jf(jargs)
    named = train.leaves_with_paths(targs)
    leaves = [x.clone().requires_grad_() for _, x in named]
    tvals, tf = _functional(tps, tkern, train.with_leaves(targs, leaves), tW, block, certain)
    for name, a, b in zip(("psi0", "psi1", "psi2", "psi2_per_t"), tvals, jvals):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-9, atol=1e-300, err_msg=name)

    jg = jax.tree_util.tree_leaves(jax.jit(jax.grad(lambda a: jf(a)[1]))(jargs))
    tg = torch.autograd.grad(tf, leaves, allow_unused=True)
    assert len(jg) == len(leaves)
    for (path, x), g, ref in zip(named, tg, jg):
        g = torch.zeros_like(x) if g is None else g  # a leaf the statistics do not read
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-9 * max(np.abs(ref).max(), 1e-300),
                                   err_msg=path)


@pytest.mark.parametrize("name,block", [(n, None) for n in sorted(CASES)]
                         + [(n, 8) for n in sorted(RBF_PARTS)])  # block chunks only these
def test_psi_statistics_match_jax(name, block, rng):
    _check(CASES[name], rng, block)


@pytest.mark.parametrize("name", ["matern52", "sum_matern_linear"])
def test_certain_inputs_without_closed_form_match_jax(name, rng):
    """No closed form: Psi1 = K(mu, Z), Psi2 = K^T K, per-t K_m K_n."""
    build = {"matern52": lambda K: K.Matern52(input_dim=3),
             "sum_matern_linear": lambda K: K.Sum(input_dim=3, parts=(K.Matern52(input_dim=3),
                                                                      K.Linear(input_dim=3)))}[name]
    assert not tps.has_closed_psi(build(tk))
    _check(build, rng, None, certain=True)
    with pytest.raises(NotImplementedError):
        tps.psi_statistics(build(tk), build(tk).init(dtype=torch.float64, device="cpu"),
                           torch.zeros(2, 3, dtype=torch.float64), torch.zeros(4, 3, dtype=torch.float64),
                           torch.ones(4, 3, dtype=torch.float64))


def test_has_closed_psi_matches_jax():
    extra = {
        "matern": lambda K: K.Matern32(input_dim=3),
        "prod_shared": lambda K: K.RBF(input_dim=3) * K.Linear(input_dim=3),
        "sum_with_mlp": lambda K: K.RBF(input_dim=3) + K.MLP(input_dim=3),
    }
    for name, build in {**CASES, **extra}.items():
        assert tps.has_closed_psi(build(tk)) == jps.has_closed_psi(build(jk)), name


@pytest.mark.parametrize("name", sorted(RBF_PARTS))
def test_rbf_time_sums_take_the_kernel_route(name, monkeypatch, rng):
    """Every RBF Psi2 time sum, an RBF part of a Sum included, is one call of
    _rbf_psi2_sum (on a float32 CUDA tensor: K1/K2; here the plain path,
    which counts itself). A disjoint Prod's sum is of per-t products, so it
    makes none."""
    calls = []
    route = tps._rbf_psi2_sum
    monkeypatch.setattr(tps, "_rbf_psi2_sum", lambda *a: calls.append(a[2].shape) or route(*a))
    kern = CASES[name](tk)
    inputs = _inputs(rng)
    p = kern.init(dtype=torch.float64, device="cpu")
    n0 = tps.plain_psi2_calls
    tps.psi_statistics(kern, p, torch.tensor(inputs["Z"]), torch.tensor(inputs["mu"]),
                       torch.tensor(np.exp(inputs["log_s"])))
    assert len(calls) == RBF_PARTS[name] == tps.plain_psi2_calls - n0
    widths = [k.input_dim for k in getattr(kern, "parts", ()) if isinstance(k, tk.RBF)]
    if isinstance(kern, tk.Sum):
        assert [shape[1] for shape in calls] == widths  # active dims sliced off first
