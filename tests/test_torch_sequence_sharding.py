"""The sequence-sharded RGP bound (rgp_tpu_torch.parallel.sequence) on ranks
spawned over gloo on the CPU, in f64.

* value and every gradient leaf against the JAX package's single-device
  ``rgp.elbo(block=None)`` (its own gates hold ``sequence_sharded_rgp_elbo``
  equal to it), for H=1, H=2, back-constraints, and back-constraints with
  amortized variances, at world sizes 2 and 4 (tests/test_sequence_sharding.py's
  narendra setup): the value at rtol 1e-9, gradients at rtol 1e-8, atol 1e-9
  (the output layer's at H=2 and under back-constraints at rtol 1e-6: see
  ``_OUT_RTOL``), after one
  ``backward()`` on every rank and no all-reduce by the caller;
  every rank returns the same bits;
* five Adam steps (``train.fit_adam``) on the sharded bound: every leaf the
  same bits on every rank after each step, and equal to
  single-process ``fit_adam`` on ``rgp.elbo`` at rtol 1e-8;
* a length that does not divide over the ranks, and a halo longer than a
  rank's block, raise.

Each world size is one spawn (a module fixture); the ranks import torch and
numpy only, so the JAX references are computed here, in the test process,
from the same numpy inputs.
"""

import functools

import numpy as np
import pytest
import torch

from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.parallel import make_mesh, sequence_sharded_rgp_elbo
from rgp_tpu_torch.parallel._launch import spawn_ranks
from rgp_tpu_torch.params import leaves_with_paths
from rgp_tpu_torch.train import fit_adam

CASES = {
    "H1": dict(H=1),
    "H2": dict(H=2),
    "back_cstr": dict(H=1, back_cstr=True),
    "amortize_var": dict(H=1, back_cstr=True, amortize_var=True),
}
_ADAM_STEPS = 5
# At H=2 and under back-constraints the output layer's f64 gradients move by
# up to ~3e-7 relative with the order of the Psi2 sum: the two packages'
# single-process gradients part by 1.2e-7 (H=2, out/kern/log_var) and 3.0e-7
# (back_cstr, out/Z) there, small sums of large terms (ROADMAP Queue 3). Those
# cases' output-layer leaves are held at 1e-6.
_OUT_RTOL = {"H2": 1e-6, "back_cstr": 1e-6}


def _cfg_kw(H=1, back_cstr=False, amortize_var=False):
    return dict(wins=[0] + [3] * H, u_win=2, y_dim=1, u_dim=1, num_inducing=8, back_cstr=back_cstr,
                mlp_hidden=(8,) if back_cstr else (), amortize_var=amortize_var)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(config keywords, params as numpy, Y, U, JAX value, JAX gradient
    leaves) for tests/test_sequence_sharding.py's setup, T=64."""
    import jax
    import jax.numpy as jnp

    from rgp_tpu.data import datasets
    from rgp_tpu.data.windows import Standardizer
    from rgp_tpu.models import rgp

    d = datasets.narendra(T=128, seed=0)
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    Y, U = sy.transform(d.y_train), su.transform(d.u_train)
    kw = _cfg_kw(**CASES[name])
    cfg = rgp.deep_rgp_config(**kw)
    params = rgp.init_params(cfg, jnp.asarray(Y), jnp.asarray(U), dtype=jnp.float64)
    value, grads = jax.jit(jax.value_and_grad(lambda p: rgp.elbo(cfg, p, jnp.asarray(Y), jnp.asarray(U),
                                                                  block=None)))(params)
    return (kw, jax.tree.map(np.asarray, params), Y, U, float(value),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _tensors(params_np, Y, U):
    p = params_from_jax(params_np, dtype=torch.float64, device="cpu")
    return p, torch.tensor(Y), torch.tensor(U)


def _rank_main(rank, inputs):
    """Every case's sharded value and gradients, the shape errors, and at
    world 2 the snapshots of five sharded Adam steps."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh(data=world)
    out = {}
    for name, (kw, params_np, Y, U) in inputs.items():
        cfg = tr.deep_rgp_config(**kw)
        p, Yt, Ut = _tensors(params_np, Y, U)
        leaves = [x.requires_grad_() for _, x in leaves_with_paths(p)]
        value = sequence_sharded_rgp_elbo(cfg, p, Yt, Ut, mesh)
        value.backward()
        out[name] = (value.item(), [None if x.grad is None else x.grad.numpy() for x in leaves])

    kw, params_np, Y, U = inputs["H1"]
    cfg = tr.deep_rgp_config(**kw)
    p, Yt, Ut = _tensors(params_np, Y, U)
    errors = {}
    for what, call in (
        ("indivisible", lambda: sequence_sharded_rgp_elbo(cfg, p, Yt[:-1], Ut[:-1], mesh)),
        ("halo", lambda: sequence_sharded_rgp_elbo(tr.deep_rgp_config(**{**kw, "wins": [0, 64 // world + 1]}),
                                                    p, Yt, Ut, mesh)),
    ):
        try:
            call()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors

    out["adam"] = _adam_snapshots(lambda q: -sequence_sharded_rgp_elbo(cfg, q, Yt, Ut, mesh), p)
    return out


def _adam_snapshots(loss, params):
    """Every leaf after each of ``_ADAM_STEPS`` Adam steps on ``loss``."""
    snaps = []

    def snapshot(q):  # fit_adam's aux_fn: runs before each step
        snaps.append([x.detach().numpy().copy() for _, x in leaves_with_paths(q)])

    fit = fit_adam(lambda q, _: loss(q), params, iters=_ADAM_STEPS, learning_rate=1e-2, aux_fn=snapshot)
    snapshot(fit.params)
    return snaps[1:]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def ranks(request, tmp_path_factory):
    inputs = {name: _jax_case(name)[:4] for name in CASES}
    store = tmp_path_factory.mktemp(f"rdv{request.param}") / "store"
    return spawn_ranks(_rank_main, request.param, backend="gloo", init_method=f"file://{store}", args=(inputs,),
                       timeout=300.0, pg_timeout=120.0)


def _same_bits(ranks, key):
    first = ranks[0][key]
    for other in ranks[1:]:
        assert other[key][0] == first[0]
        for a, b in zip(other[key][1], first[1]):
            assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_sharded_matches_jax(ranks, name):
    kw, params_np, _, _, ref_value, ref_grads = _jax_case(name)
    _same_bits(ranks, name)
    value, grads = ranks[0][name]
    np.testing.assert_allclose(value, ref_value, rtol=1e-9)
    paths = [path for path, _ in leaves_with_paths(params_np)]
    assert len(grads) == len(ref_grads) == len(paths)
    for path, g, r in zip(paths, grads, ref_grads):
        # a leaf the bound does not use (mu under back-constraints) gets no gradient; JAX's is zero
        g = np.zeros_like(r) if g is None else g
        rtol = _OUT_RTOL.get(name, 1e-8) if path.startswith("out/") else 1e-8
        np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-9, err_msg=path)


def test_shapes_that_do_not_shard_raise(ranks):
    for r in ranks:
        assert "does not divide" in r["errors"]["indivisible"]
        assert "longer than a rank's block" in r["errors"]["halo"]


def test_sharded_adam_steps_match_single_process(ranks):
    kw, params_np, Y, U = _jax_case("H1")[:4]
    cfg = tr.deep_rgp_config(**kw)
    p, Yt, Ut = _tensors(params_np, Y, U)
    ref = _adam_snapshots(lambda q: -tr.elbo(cfg, q, Yt, Ut, block=None), p)
    assert len(ranks[0]["adam"]) == len(ref) == _ADAM_STEPS
    for step, r_leaves in enumerate(ref):
        for i, r in enumerate(r_leaves):
            ours = ranks[0]["adam"][step][i]
            assert all(np.array_equal(other["adam"][step][i], ours) for other in ranks[1:]), \
                f"the ranks' leaf {i} differs after step {step}"
            np.testing.assert_allclose(ours, r, rtol=1e-8)
