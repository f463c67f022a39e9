"""The multi-output (Dy > 1) and multi-dim-latent (Q_h > 1) RGP shapes of
tests/test_multioutput.py: rgp_tpu_torch.models.rgp against rgp_tpu.models.rgp
on the CPU in float64, from the JAX package's init carried over with
``convert.params_from_jax`` and perturbed by seeded numpy noise (so no
parameter sits at a symmetric init value).

* ELBO at rtol 1e-10 (the same bound, summed in another order);
* each gradient leaf within 1e-7 of the leaf's largest entry (small sums of
  large terms in the output layer, as tests/test_torch_layer_step.py);
* a 20-step freerun's means and variances at atol 1e-8 (two LAPACK builds'
  rounding carried through the closed loop);
* ``config1.fit_restarts`` (restarts as one batch) runs on the ``y_dim=2``
  shape and returns one restart's tree and every restart's final ELBO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.models import rgp as jr
from rgp_tpu_torch.bench import config1
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.params import leaves_with_paths, with_leaves

_SHAPES = {
    # tests/test_multioutput.py: config arguments and the output width of the data
    "y_dim2": (dict(wins=[0, 3], u_win=2, y_dim=2, u_dim=1, num_inducing=10), 2),
    "q_dims2": (dict(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=10, q_dims=[2]), 1),
    "wins_042_q31": (dict(wins=[0, 4, 2], u_win=3, y_dim=1, u_dim=1, num_inducing=8, q_dims=[3, 1]), 1),
}


def _data(T=50, Dy=2, Du=1, seed=0):
    """tests/test_multioutput.py's data."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((T, Du))
    Y = np.zeros((T, Dy))
    for t in range(2, T):
        Y[t, 0] = 0.6 * Y[t - 1, 0] + np.tanh(U[t - 1, 0]) + 0.05 * rng.standard_normal()
        if Dy > 1:
            Y[t, 1] = 0.4 * Y[t - 1, 1] - 0.5 * Y[t - 1, 0] + 0.05 * rng.standard_normal()
    return Y, U


def _paths(tree, prefix=""):
    """{'/'-joined key path: numpy leaf} of a JAX parameter tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _paths(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module", params=sorted(_SHAPES))
def carried(request):
    kw, dy = _SHAPES[request.param]
    Y, U = _data(Dy=dy)
    cfg, tcfg = jr.deep_rgp_config(**kw), tr.deep_rgp_config(**kw)
    rng = np.random.default_rng(11)
    jp = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)),
                      jr.init_params(cfg, jnp.asarray(Y), jnp.asarray(U), dtype=jnp.float64))
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    return cfg, tcfg, jax.tree.map(jnp.asarray, jp), tp, Y, U


def test_elbo_and_gradients_match_jax(carried):
    cfg, tcfg, jp, tp, Y, U = carried
    jY, jU, tY, tU = jnp.asarray(Y), jnp.asarray(U), torch.tensor(Y), torch.tensor(U)
    e_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: jr.elbo(cfg, p, jY, jU, block=None)))(jp)
    leaves = [x.clone().requires_grad_() for _, x in leaves_with_paths(tp)]
    paths = [k for k, _ in leaves_with_paths(tp)]
    e = tr.elbo(tcfg, with_leaves(tp, leaves), tY, tU, block=None)
    grads = torch.autograd.grad(e, leaves)
    np.testing.assert_allclose(float(e.detach()), float(e_ref), rtol=1e-10)
    ref = _paths(g_ref)
    assert sorted(ref) == sorted(paths)
    for path, g in zip(paths, grads):
        b = ref[path]
        np.testing.assert_allclose(g.numpy(), b, rtol=0, atol=1e-7 * np.abs(b).max(), err_msg=path)


def test_freerun_matches_jax(carried):
    cfg, tcfg, jp, tp, Y, U = carried
    ref = jr.freerun(cfg, jp, jnp.asarray(Y), jnp.asarray(U), jnp.asarray(U[:20]))
    with torch.no_grad():
        ours = tr.freerun(tcfg, tp, torch.tensor(Y), torch.tensor(U), torch.tensor(U[:20]))
    for a, b in zip(ours, ref):
        assert a.shape == (20, Y.shape[1])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)


def test_fit_restarts_runs_on_two_outputs():
    kw, dy = _SHAPES["y_dim2"]
    Y, U = (torch.tensor(x) for x in _data(Dy=dy))
    cfg = tr.deep_rgp_config(**kw)
    kept, elbos = config1.fit_restarts(cfg, Y, U, 5, 1e-2, range(3))
    init = tr.init_params(cfg, Y, U, seed=0, dtype=torch.float64, device="cpu")
    assert [(k, tuple(x.shape)) for k, x in leaves_with_paths(kept)] == \
        [(k, tuple(x.shape)) for k, x in leaves_with_paths(init)]
    assert len(elbos) == 3 and all(np.isfinite(elbos))
    with torch.no_grad():
        m, v = tr.freerun(cfg, kept, Y, U, U[:10])
    assert m.shape == v.shape == (10, 2) and bool(torch.isfinite(m).all()) and bool((v > 0).all())
