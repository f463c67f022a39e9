"""rgp_tpu_torch.kernels against rgp_tpu.kernels on the CPU in float64.

For every kernel, and for active_dims, Sum and Prod: K(X, X2), the Gram K(X)
and Kdiag(X) from the same seeded inputs and perturbed hyperparameters, at
rtol 1e-10, and the gradient of a random linear functional of all three with
respect to every hyperparameter and both inputs, each to 1e-10 of its largest
entry. Matern kernels at coincident inputs must give finite gradients that
match. The port's leaf order for a Sum's tuple of part dicts is the order of
``jax.flatten_util.ravel_pytree``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import rgp_tpu.kernels as jk
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax

# each case builds the same kernel from either package's module
CASES = {
    "rbf": lambda K: K.RBF(input_dim=3),
    "rbf_iso": lambda K: K.RBF(input_dim=3, ard=False),
    "rbf_active": lambda K: K.RBF(input_dim=2, active_dims=(0, 2)),
    "linear": lambda K: K.Linear(input_dim=3),
    "linear_active": lambda K: K.Linear(input_dim=1, active_dims=(1,)),
    "white": lambda K: K.White(input_dim=3),
    "bias": lambda K: K.Bias(input_dim=3),
    "exponential": lambda K: K.Exponential(input_dim=3),
    "matern32": lambda K: K.Matern32(input_dim=3),
    "matern52": lambda K: K.Matern52(input_dim=3),
    "matern52_active": lambda K: K.Matern52(input_dim=2, active_dims=(1, 2), ard=False),
    "ratquad": lambda K: K.RatQuad(input_dim=3),
    "stdperiodic": lambda K: K.StdPeriodic(input_dim=3),
    "mlp": lambda K: K.MLP(input_dim=3),
    "sum": lambda K: K.RBF(input_dim=3) + K.Linear(input_dim=3) + K.White(input_dim=3),
    "sum_active": lambda K: K.Sum(input_dim=3, parts=(K.Matern32(input_dim=2, active_dims=(0, 1)),
                                                      K.Bias(input_dim=3))),
    "prod": lambda K: K.RBF(input_dim=2, active_dims=(0, 1)) * K.Linear(input_dim=1, active_dims=(2,)),
    "prod_shared": lambda K: K.Prod(input_dim=3, parts=(K.StdPeriodic(input_dim=3), K.MLP(input_dim=3))),
}


def _pair(name, rng):
    jkern, tkern = CASES[name](jk), CASES[name](tk)
    jp = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(-0.4, 0.4, np.shape(a)),
                      jkern.init(dtype=jnp.float64))
    return jkern, tkern, jp, params_from_jax(jp, dtype=torch.float64, device="cpu")


def _functional(kern, a, W):
    p, X, X2 = a["p"], a["X"], a["X2"]
    return ((kern.K(p, X, X2) * W[0]).sum() + (kern.K(p, X) * W[1]).sum()
            + (kern.Kdiag(p, X) * W[2]).sum())


def _check(name, rng, X, X2):
    jkern, tkern, jp, tp = _pair(name, rng)
    W = [rng.standard_normal((X.shape[0], X2.shape[0])), rng.standard_normal((X.shape[0],) * 2),
         rng.standard_normal(X.shape[0])]
    jargs = {"p": jax.tree.map(jnp.asarray, jp), "X": jnp.asarray(X), "X2": jnp.asarray(X2)}
    targs = {"p": tp, "X": torch.tensor(X), "X2": torch.tensor(X2)}

    jvals = jax.jit(lambda a: (jkern.K(a["p"], a["X"], a["X2"]), jkern.K(a["p"], a["X"]),
                               jkern.Kdiag(a["p"], a["X"])))(jargs)
    for j, t in zip(jvals, (tkern.K(tp, targs["X"], targs["X2"]), tkern.K(tp, targs["X"]),
                            tkern.Kdiag(tp, targs["X"]))):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10, atol=1e-300)

    jg = jax.tree_util.tree_leaves(
        jax.jit(jax.grad(lambda a: _functional(jkern, a, [jnp.asarray(w) for w in W])))(jargs))
    named = train.leaves_with_paths(targs)
    leaves = [x.clone().requires_grad_() for _, x in named]
    tg = torch.autograd.grad(_functional(tkern, train.with_leaves(targs, leaves), [torch.tensor(w) for w in W]),
                             leaves, allow_unused=True)
    assert len(jg) == len(leaves)
    for (path, x), g, ref in zip(named, tg, jg):
        g = torch.zeros_like(x) if g is None else g  # an input the kernel does not read
        ref = np.asarray(ref)
        assert np.isfinite(g.numpy()).all(), path
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-10 * max(np.abs(ref).max(), 1e-300),
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_jax(name, rng):
    _check(name, rng, rng.standard_normal((7, 3)), rng.standard_normal((5, 3)))


@pytest.mark.parametrize("name", ["matern32", "matern52", "exponential", "matern52_active", "sum_active"])
def test_coincident_inputs_give_finite_matching_gradients(name, rng):
    """X2 repeats rows of X and X repeats a row: r = 0 off the Gram's
    diagonal too, where sqrt's slope is infinite unless masked."""
    X = rng.standard_normal((6, 3))
    X[3] = X[1]
    _check(name, rng, X, X[[1, 0, 4, 1]])


def test_kernel_algebra_matches_jax():
    a, b = tk.RBF(input_dim=2), tk.Linear(input_dim=1, active_dims=(3,))
    ja, jb = jk.RBF(input_dim=2), jk.Linear(input_dim=1, active_dims=(3,))
    for ours, ref in ((a + b, ja + jb), (a * b, ja * jb), ((a + b) + a, (ja + jb) + ja),
                      ((a * b) * b, (ja * jb) * jb)):
        assert type(ours).__name__ == type(ref).__name__
        assert ours.input_dim == ref.input_dim == 4
        assert [type(k).__name__ for k in ours.parts] == [type(k).__name__ for k in ref.parts]


def test_sum_leaf_order_is_ravel_pytree_order(rng):
    """train.leaves_with_paths orders a Sum's tuple of part dicts as
    jax.flatten_util.ravel_pytree does."""
    _, _, jp, tp = _pair("sum", rng)
    tree_j = {"kern": jp, "Z": rng.standard_normal((2, 3))}
    flat_j, _ = ravel_pytree(jax.tree.map(jnp.asarray, tree_j))
    tree_t = params_from_jax(tree_j, dtype=torch.float64, device="cpu")
    flat_t = torch.cat([x.reshape(-1) for _, x in train.leaves_with_paths(tree_t)])
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert [p for p, _ in train.leaves_with_paths(tree_t)][:3] == ["Z", "kern/0/log_ls", "kern/0/log_var"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_matches_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for name in sorted(CASES):
        ours = CASES[name](tk).init(dtype=dtype, device="cpu")
        ref = CASES[name](jk).init(dtype=jdt)
        a = [x.numpy() for _, x in train.leaves_with_paths(ours)]
        b = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=name)
