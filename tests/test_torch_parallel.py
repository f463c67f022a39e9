"""The mesh, the data-parallel and the inducing-sharded collapsed bounds
(rgp_tpu_torch.parallel.mesh and .inducing) on ranks spawned over gloo on the
CPU, in f64, at world sizes 2 and 4.

* ``make_mesh``: the JAX mesh's shape dict, each axis's group and place,
  and a psum along each axis (tests/test_dist.py:26-28, at the world's size);
  a mesh that does not fill the world raises;
* ``data_parallel_collapsed_elbo`` on tests/test_dist.py's problem (T=64,
  Q=3, M=8) against the JAX package's single-device ``collapsed_bound``,
  uncertain and certain inputs: the value at rtol 1e-10, the gradients of
  every parameter leaf and of X_mu at rtol 1e-8, atol 1e-10;
* ``psi2_rows`` against the JAX package's, with and without ``block``, at
  rtol 1e-12 (tests/test_inducing_sharding.py:35-44; no ranks);
* ``inducing_sharded_collapsed_elbo`` (T=48, M=16) against ``collapsed_bound``
  for RBF, certain inputs, Linear and ``Y_var``: value at rtol 1e-10,
  gradients at rtol 1e-8, atol 1e-10.

Every rank returns the same bits. Gradients come from one ``backward()`` on
every rank, with no all-reduce by the caller. Each world size is one spawn
(a module fixture); the ranks import torch and numpy only, so the JAX
references are computed here from the same numpy inputs.
"""

import functools

import numpy as np
import pytest
import torch

from rgp_tpu_torch import kernels as tk
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.parallel import (
    data_parallel_collapsed_elbo,
    inducing_sharded_collapsed_elbo,
    make_mesh,
    psi2_rows,
)
from rgp_tpu_torch.parallel._collectives import psum
from rgp_tpu_torch.parallel._launch import spawn_ranks
from rgp_tpu_torch.params import leaves_with_paths

# name: (sharded function, kernel, T, M, uncertain inputs, Y_var)
CASES = {
    "dp_uncertain": ("data_parallel", "RBF", 64, 8, True, False),
    "dp_certain": ("data_parallel", "RBF", 64, 8, False, False),
    "inducing_rbf": ("inducing", "RBF", 48, 16, True, False),
    "inducing_certain": ("inducing", "RBF", 48, 16, False, False),
    "inducing_linear": ("inducing", "Linear", 48, 16, True, False),
    "inducing_y_var": ("inducing", "RBF", 48, 16, True, True),
}
_Q = 3


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(kernel name, params as numpy, X_mu, X_s, Y, Y_var, JAX value, JAX
    gradient leaves of (params, X_mu)) for the JAX tests' problems."""
    import jax
    import jax.numpy as jnp

    from rgp_tpu.inference.collapsed_vi import collapsed_bound
    from rgp_tpu.kernels import RBF, Linear
    from rgp_tpu.models import sparse_gp
    from rgp_tpu.ops.psi_stats import psi_statistics

    _, kname, T, M, uncertain, with_var = CASES[name]
    rng = np.random.default_rng(0)
    X_mu = rng.standard_normal((T, _Q))
    X_s = rng.uniform(0.05, 0.3, (T, _Q)) if uncertain else None
    Y = rng.standard_normal((T, 2))
    Y_var = np.random.default_rng(1).uniform(0.01, 0.1, Y.shape) if with_var else None
    kern = {"RBF": RBF, "Linear": Linear}[kname](input_dim=_Q)
    params = sparse_gp.init_params(sparse_gp.SparseGPConfig(kern, M), X_mu, noise=0.3, dtype=jnp.float64)
    Xs = None if X_s is None else jnp.asarray(X_s)
    Yv = None if Y_var is None else jnp.asarray(Y_var)

    def bound(p, Xm):
        stats = psi_statistics(kern, p["kern"], p["Z"], Xm, Xs, block=None)
        return collapsed_bound(kern, p["kern"], p["Z"], p["log_noise"], stats, jnp.asarray(Y), Y_var=Yv)

    value, grads = jax.jit(jax.value_and_grad(bound, argnums=(0, 1)))(params, jnp.asarray(X_mu))
    return (kname, jax.tree.map(np.asarray, params), X_mu, X_s, Y, Y_var, float(value),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _kernel(kname):
    return {"RBF": tk.RBF, "Linear": tk.Linear}[kname](input_dim=_Q)


def _mesh_report(rank, world):
    """Each mesh's shape, places and a psum of the rank along each axis."""
    shapes = [dict(data=world)] + ([dict(data=2, chain=2), dict(chain=2, particle=2)] if world == 4 else [])
    out = []
    for kw in shapes:
        mesh = make_mesh(**kw)
        sums = {a: float(psum(torch.tensor(float(rank), dtype=torch.float64), mesh.group(a)))
                for a in mesh.shape}
        out.append((kw, mesh.shape, {a: mesh.index(a) for a in mesh.shape}, sums))
    try:
        make_mesh(data=world + 1)
        raised = None
    except ValueError as e:
        raised = str(e)
    return out, raised


def _rank_main(rank, inputs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh(data=world)
    out = {"mesh": _mesh_report(rank, world)}
    for name, (kname, params_np, X_mu, X_s, Y, Y_var) in inputs.items():
        fn = {"data_parallel": data_parallel_collapsed_elbo, "inducing": inducing_sharded_collapsed_elbo}[
            CASES[name][0]]
        p = params_from_jax(params_np, dtype=torch.float64, device="cpu")
        Xm = torch.tensor(X_mu, requires_grad=True)
        leaves = [x.requires_grad_() for _, x in leaves_with_paths(p)] + [Xm]
        Xs, Yv = (None if x is None else torch.tensor(x) for x in (X_s, Y_var))
        value = fn(_kernel(kname), p["kern"], p["Z"], p["log_noise"], Xm, Xs, torch.tensor(Y), Yv, mesh)
        value.backward()
        out[name] = (value.item(), [x.grad.numpy() for x in leaves])
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def ranks(request, tmp_path_factory):
    inputs = {name: _jax_case(name)[:6] for name in CASES}
    store = tmp_path_factory.mktemp(f"rdv{request.param}") / "store"
    return spawn_ranks(_rank_main, request.param, backend="gloo", init_method=f"file://{store}", args=(inputs,),
                       timeout=300.0, pg_timeout=120.0)


def test_mesh_shape_groups_and_psum(ranks):
    world = len(ranks)
    for rank, r in enumerate(ranks):
        meshes, raised = r["mesh"]
        assert "needs" in raised and f"the world has {world}" in raised
        for kw, shape, index, sums in meshes:
            assert shape == {"data": 1, "chain": 1, "particle": 1, **kw}
            grid = np.arange(world).reshape(shape["data"], shape["chain"], shape["particle"])
            place = np.argwhere(grid == rank)[0]
            for k, axis in enumerate(("data", "chain", "particle")):
                assert index[axis] == place[k]
                line = np.moveaxis(grid, k, -1)[tuple(np.delete(place, k))]
                assert sums[axis] == float(line.sum()), (kw, axis)


def test_mesh_without_a_group_is_one_process():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "chain": 1, "particle": 1}
    assert all(mesh.group(a) is None and mesh.index(a) == 0 for a in mesh.shape)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(chain=2)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_bound_matches_jax(ranks, name):
    *_, ref_value, ref_grads = _jax_case(name)
    value, grads = ranks[0][name]
    for other in ranks[1:]:
        assert other[name][0] == value and all(np.array_equal(a, b) for a, b in zip(other[name][1], grads))
    np.testing.assert_allclose(value, ref_value, rtol=1e-10)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("block", [None, 13])
def test_psi2_rows_matches_jax(block):
    import jax.numpy as jnp

    from rgp_tpu.kernels import RBF
    from rgp_tpu.parallel.inducing import psi2_rows as jax_psi2_rows

    _, params_np, X_mu, X_s, *_ = _jax_case("inducing_rbf")
    kp, Z = params_np["kern"], params_np["Z"]
    ref = jax_psi2_rows(RBF(input_dim=_Q), _jax_tree(kp), jnp.asarray(Z[:4]), jnp.asarray(Z), jnp.asarray(X_mu),
                        jnp.asarray(X_s), block=block)
    tp = params_from_jax(kp, dtype=torch.float64, device="cpu")
    ours = psi2_rows(tk.RBF(input_dim=_Q), tp, torch.tensor(Z[:4]), torch.tensor(Z), torch.tensor(X_mu),
                     torch.tensor(X_s), block=block)
    assert ours.shape == (4, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12)


def _jax_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)
