"""The training slice: rgp_tpu_torch.train and the gradients of the port's
ELBO against rgp_tpu on the CPU.

Tolerances:
* Adam on a smooth float64 quadratic against optax step by step: rtol 1e-10
  (the two differ only in the rounding order of the same update);
* ELBO gradients: per leaf, max error <= 1e-8 max|g| of that leaf (float64;
  the two packages' LAPACK builds round differently);
* training trajectories: the golden values at steps 0, 9 and 24 at rtol 1e-6
  (tests/test_golden_regression.py), and the JAX package's own ``fit_adam``
  at rtol 1e-9 through step 33. Later steps are not held, because the
  reference's trajectory crosses discrete ladder rungs there: parameters
  that differ by ~1e-11 land on different sides of a rung, and the two runs
  split by nats at step 39 although both packages give the same ELBO at the
  same parameters (ROADMAP.md Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgp_tpu import train as jtrain
from rgp_tpu.data import datasets as jd
from rgp_tpu.data.windows import Standardizer as JStandardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch import train
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.data import datasets as td
from rgp_tpu_torch.models import rgp as tr

_GOLDEN_TRAJ = {  # tests/test_golden_regression.py
    0: -5946.347076393514,
    9: -3795.857900524881,
    24: -2375.0372891290613,
}


def _leaves(tree):
    return [np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)
            for _, x in train.leaves_with_paths(tree)]


def _quadratic(lib):
    """A smooth coupled quadratic over a dict of two leaves, in jnp or torch."""
    a = np.linspace(0.5, 3.0, 6).reshape(2, 3)
    c = np.linspace(-1.0, 2.0, 6).reshape(2, 3)
    a, c = (jnp.asarray(a), jnp.asarray(c)) if lib is jnp else (torch.tensor(a), torch.tensor(c))

    def loss(p):
        x, y = p["x"], p["y"]
        s = x.sum() + y.sum()
        return 0.5 * (a * (x - c) ** 2).sum() + 0.5 * ((y - 0.3) ** 2).sum() * 4.0 + 0.05 * s * s

    return loss


@pytest.mark.parametrize("case", ["constant", "cosine", "frozen"])
def test_adam_matches_optax_on_a_quadratic(case):
    iters = 100
    x0 = np.linspace(0.1, 0.9, 6).reshape(2, 3)
    y0 = np.array([1.5, -0.5])
    if case == "cosine":
        lr_j = optax.cosine_decay_schedule(0.05, iters, 0.01)
        lr_t = train.cosine_decay_schedule(0.05, iters, 0.01)
    else:
        lr_j = lr_t = 0.05
    pj = {"x": jnp.asarray(x0), "y": jnp.asarray(y0)}
    pt = {"x": torch.tensor(x0), "y": torch.tensor(y0)}
    frozen_j = frozen_t = None
    if case == "frozen":
        frozen_j = jtrain.freeze_mask(pj, lambda path: path == "y")
        frozen_t = train.freeze_mask(pt, lambda path: path == "y")
    ref = jtrain.fit_adam(_quadratic(jnp), pj, iters=iters, optimizer=optax.adam(lr_j), frozen=frozen_j)
    ours = train.fit_adam(_quadratic(torch), pt, iters=iters, learning_rate=lr_t, frozen=frozen_t)
    assert ours.losses.shape == (iters,) and ours.losses.dtype == torch.float64
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-10)
    for a, b in zip(_leaves(ours.params), _leaves(ref.params)):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    if case == "frozen":
        np.testing.assert_array_equal(ours.params["y"].numpy(), y0)
    np.testing.assert_array_equal(pt["x"].numpy(), x0)  # the input is not modified


def test_cosine_schedule_matches_optax():
    ours = train.cosine_decay_schedule(0.01, 1000, 0.01)
    ref = optax.cosine_decay_schedule(0.01, 1000, 0.01)
    steps = [0, 1, 17, 500, 999, 1000, 1500]
    np.testing.assert_allclose([ours(i) for i in steps], [float(ref(i)) for i in steps], rtol=1e-12)


@pytest.fixture(scope="module")
def carried():
    """A JAX init at M=20 perturbed by seeded numpy noise, and its carry-over
    (the setup of tests/test_torch_rgp.py)."""
    d = jd.actuator()
    sy, su = JStandardizer.fit(d.y_train), JStandardizer.fit(d.u_train)
    Y = jnp.asarray(sy.transform(d.y_train), jnp.float64)
    U = jnp.asarray(su.transform(d.u_train), jnp.float64)
    cfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=20)
    tcfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=20)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)),
                      jr.init_params(cfg, Y, U, dtype=jnp.float64, seed=0))
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    return cfg, tcfg, jp, tp, (Y, U), (torch.tensor(np.asarray(Y)), torch.tensor(np.asarray(U)))


def test_freeze_mask_matches_jax(carried):
    _, _, jp, tp, _, _ = carried

    def pred(path):
        return path.endswith("/Z") or path == "out/log_noise" or path.startswith("layers/0/kern")

    ours = [(path, f) for path, f in train.leaves_with_paths(train.freeze_mask(tp, pred))]
    ref = jax.tree.leaves(jtrain.freeze_mask(jp, pred))
    assert [f for _, f in ours] == [bool(f) for f in ref]
    assert sum(f for _, f in ours) == 5
    assert ("layers/0/Z", True) in ours and ("out/Z", True) in ours


def test_elbo_gradients_match_jax(carried):
    cfg, tcfg, jp, tp, (Y, U), (tY, tU) = carried
    ref = jax.jit(jax.grad(lambda p: jr.elbo(cfg, p, Y, U, block=None)))(jp)
    leaves = [x.clone().requires_grad_() for _, x in train.leaves_with_paths(tp)]
    tr.elbo(tcfg, train.with_leaves(tp, leaves), tY, tU, block=None).backward()
    refs = _leaves(ref)
    assert len(leaves) == len(refs) == 12
    for (path, _), x, g in zip(train.leaves_with_paths(tp), leaves, refs):
        err = np.abs(x.grad.numpy() - g).max()
        assert err <= 1e-8 * np.abs(g).max(), (path, err, np.abs(g).max())


def test_neg_elbo_is_the_training_loss(carried):
    _, tcfg, _, tp, _, (tY, tU) = carried
    assert float(tr.neg_elbo(tcfg, tp, tY, tU, block=None)) == -float(tr.elbo(tcfg, tp, tY, tU, block=None))


def test_fit_adam_golden_trajectory():
    """The golden setup (f64, M=50, Adam 1e-2 from init_params(seed=0)): the
    golden ELBOs at steps 0, 9 and 24, and the JAX package's fit_adam step by
    step through step 33 (see the module note for why not further)."""
    iters = 34
    d = td.standardized_tensors(td.actuator(), dtype=torch.float64, device="cpu")
    cfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    params = tr.init_params(cfg, d.Y, d.U, dtype=torch.float64, seed=0, device="cpu")
    ours = train.fit_adam(lambda p: tr.neg_elbo(cfg, p, d.Y, d.U, block=None), params,
                          iters=iters, learning_rate=1e-2)
    elbos = -ours.losses.numpy()
    for i, golden in _GOLDEN_TRAJ.items():
        np.testing.assert_allclose(elbos[i], golden, rtol=1e-6, err_msg=f"step {i}")

    Y, U = jnp.asarray(d.Y.numpy()), jnp.asarray(d.U.numpy())
    jcfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    jparams = jr.init_params(jcfg, Y, U, dtype=jnp.float64, seed=0)
    ref = jtrain.fit_adam(lambda p: -jr.elbo(jcfg, p, Y, U, block=None), jparams,
                          iters=iters, learning_rate=1e-2)
    np.testing.assert_allclose(elbos, -np.asarray(ref.losses), rtol=1e-9)


def test_fit_adam_with_whitening_refresh_matches_jax(carried):
    """aux_fn = compute_whitenings refreshed every 10 steps, 20 steps at M=20,
    the schedule bench.py trains with."""
    cfg, tcfg, jp, tp, (Y, U), (tY, tU) = carried
    ref = jtrain.fit_adam(
        lambda p, wh: -jr.elbo(cfg, p, Y, U, block=None, whitening=wh), jp, iters=20,
        optimizer=optax.adam(optax.cosine_decay_schedule(1e-2, 20, 0.01)),
        aux_fn=lambda p: jr.compute_whitenings(cfg, p, Y, U, block=None), aux_every=10,
    )
    ours = train.fit_adam(
        lambda p, wh: -tr.elbo(tcfg, p, tY, tU, block=None, whitening=wh), tp, iters=20,
        learning_rate=train.cosine_decay_schedule(1e-2, 20, 0.01),
        aux_fn=lambda p: tr.compute_whitenings(tcfg, p, tY, tU, block=None), aux_every=10,
    )
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    for a, b in zip(_leaves(ours.params), _leaves(ref.params)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


# --------------------------------------------------------------- config 4's training loops

from jax.flatten_util import ravel_pytree  # noqa: E402

import rgp_tpu.kernels as jk  # noqa: E402
from rgp_tpu.data import windows as jw  # noqa: E402
from rgp_tpu.models import sparse_gp as jsgp  # noqa: E402
from rgp_tpu.models import svgp as jsvgp  # noqa: E402
import rgp_tpu_torch.kernels as tk  # noqa: E402
from rgp_tpu_torch import params as tparams  # noqa: E402
from rgp_tpu_torch.models import sparse_gp as tsgp  # noqa: E402
from rgp_tpu_torch.models import svgp as tsvgp  # noqa: E402


def test_ravel_matches_ravel_pytree():
    """Order (dict keys sorted, lists in order, 0-d leaves as one entry),
    values, and a round trip through ``unravel`` that keeps gradients."""
    rng = np.random.default_rng(3)
    tree = {"z": rng.standard_normal((2, 3)), "a": [rng.standard_normal(4), {"y": np.float64(0.5),
                                                                             "b": rng.standard_normal((1, 2))}]}
    ref, junravel = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    tp = params_from_jax(tree, dtype=torch.float64, device="cpu")
    flat, unravel = tparams.ravel(tp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    v = torch.arange(flat.numel(), dtype=torch.float64, requires_grad=True)
    back = unravel(v)
    for (path, a), b in zip(train.leaves_with_paths(back), jax.tree.leaves(junravel(jnp.arange(flat.numel(),
                                                                                                dtype=jnp.float64)))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b), err_msg=path)
    assert back["a"][1]["y"].shape == () and isinstance(back["a"], list)
    (sum((x * x).sum() for _, x in train.leaves_with_paths(back))).backward()
    np.testing.assert_array_equal(v.grad.numpy(), 2.0 * v.detach().numpy())


@pytest.fixture(scope="module")
def corpus():
    """long_corpus(T=800, seed=1)'s NARX design (y_win=3, u_win=2), as in
    tests/test_minibatch_training.py."""
    d = jd.long_corpus(T=800, seed=1)
    sy, su = JStandardizer.fit(d.y_train), JStandardizer.fit(d.u_train)
    X, Y = jw.narx_design(sy.transform(d.y_train), su.transform(d.u_train), 3, 2)
    return np.asarray(X), np.asarray(Y)


def _jax_indices(key, iters, batch_size, n):
    """fit_minibatch's draws: one ``randint`` per ``split`` key."""
    return np.stack([np.asarray(jax.random.randint(k, (batch_size,), 0, n))
                     for k in jax.random.split(key, iters)])


def _close(ours, ref, rtol):
    for (path, a), b in zip(train.leaves_with_paths(ours), jax.tree.leaves(ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=path)


def test_fit_minibatch_natgrad_matches_jax(corpus):
    """20 steps: q(u) by natural gradients on a cosine schedule, the rest by
    clipped cosine Adam (config 4's optimizer), the JAX draws replayed;
    losses and parameters at rtol 1e-8."""
    X, Y = corpus
    T = X.shape[0]
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=5), 12)
    tcfg = tsvgp.SVGPConfig(tk.RBF(input_dim=5), 12)
    jp = jsvgp.init_params(cfg, X, noise=0.3, dtype=jnp.float64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64, device="cpu")
    iters, bs, key = 20, 64, jax.random.PRNGKey(4)
    ref = jtrain.fit_minibatch(
        lambda p, b: -jsvgp.elbo(cfg, p, b["X"], b["Y"], T_total=T), jp, {"X": jnp.asarray(X), "Y": jnp.asarray(Y)},
        iters=iters, batch_size=bs, key=key,
        optimizer=optax.chain(optax.clip_by_global_norm(10.0), optax.adam(optax.cosine_decay_schedule(5e-2, iters, 0.01))),
        natgrad_block="qu", natgrad_lr=optax.cosine_decay_schedule(0.3, iters, 0.05),
    )
    ours = train.fit_minibatch(
        lambda p, b: -tsvgp.elbo(tcfg, p, b["X"], b["Y"], T_total=T), tp, {"X": torch.tensor(X), "Y": torch.tensor(Y)},
        iters=iters, batch_size=bs, indices=torch.tensor(_jax_indices(key, iters, bs, T)),
        learning_rate=train.cosine_decay_schedule(5e-2, iters, 0.01), clip_norm=10.0,
        natgrad_block="qu", natgrad_lr=train.cosine_decay_schedule(0.3, iters, 0.05),
    )
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    _close(ours.params, ref.params, 1e-8)
    assert float(ours.losses[-1]) < float(ours.losses[0])


def test_fit_minibatch_aux_trailing_chunk_exact_iters(corpus):
    """tests/test_minibatch_training.py's case: iters=25 with aux_every=10
    runs exactly 25 updates, the aux refreshed before steps 0, 10 and 20, and
    equals aux_every=5 (a constant aux) at rtol 1e-12 and the JAX package at
    rtol 1e-8, the draws replayed."""
    X, Y = corpus
    X, Y = X[:297], Y[:297]
    T = X.shape[0]
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=5), 8)
    tcfg = tsvgp.SVGPConfig(tk.RBF(input_dim=5), 8)
    jp = jsvgp.init_params(cfg, X, noise=0.3, dtype=jnp.float64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64, device="cpu")
    key = jax.random.PRNGKey(2)
    idx = torch.tensor(_jax_indices(key, 25, 16, T))
    refreshed = []

    def aux_fn(p):
        refreshed.append(len(refreshed))
        return 0.0

    def loss(p, b, aux=None):
        return -tsvgp.elbo(tcfg, p, b[0], b[1], T_total=T)

    data = (torch.tensor(X), torch.tensor(Y))
    kw = dict(batch_size=16, indices=idx, learning_rate=1e-2)
    ours = train.fit_minibatch(loss, tp, data, iters=25, aux_fn=aux_fn, aux_every=10, **kw)
    assert ours.losses.shape == (25,) and len(refreshed) == 3
    even = train.fit_minibatch(loss, tp, data, iters=25, aux_fn=lambda p: 0.0, aux_every=5, **kw)
    for (path, a), (_, b) in zip(train.leaves_with_paths(ours.params), train.leaves_with_paths(even.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, err_msg=path)
    ref = jtrain.fit_minibatch(lambda p, b, aux=None: -jsvgp.elbo(cfg, p, b[0], b[1], T_total=T), jp,
                               (jnp.asarray(X), jnp.asarray(Y)), iters=25, batch_size=16, key=key,
                               learning_rate=1e-2, aux_fn=lambda p: 0.0, aux_every=10)
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    _close(ours.params, ref.params, 1e-8)


def test_fit_minibatch_draws_on_a_seeded_generator(corpus):
    """Without ``indices`` the draws come from a generator seeded by
    ``seed``: the same seed gives the same run, another seed another."""
    X, Y = corpus
    tcfg = tsgp.SparseGPConfig(tk.RBF(input_dim=5), 6)
    tp = tsgp.init_params(tcfg, X, dtype=torch.float64, device="cpu")
    data = {"X": torch.tensor(X), "Y": torch.tensor(Y)}

    def run(**kw):
        return train.fit_minibatch(lambda p, b: -tsgp.elbo(tcfg, p, b["X"], b["Y"]), tp, data, iters=3,
                                   batch_size=32, **kw).losses

    assert torch.equal(run(seed=1), run(seed=1)) and not torch.equal(run(seed=1), run(seed=2))
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(run(generator=gen), run(seed=1))
    with pytest.raises(ValueError, match="indices"):
        run(indices=torch.zeros((2, 32), dtype=torch.int64))


def _sgp_problem(corpus, M=6, rows=200):
    X, Y = corpus
    X, Y = X[:rows], Y[:rows]
    cfg = jsgp.SparseGPConfig(jk.RBF(input_dim=5), M)
    tcfg = tsgp.SparseGPConfig(tk.RBF(input_dim=5), M)
    jp = jsgp.init_params(cfg, X, noise=0.3, dtype=jnp.float64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64, device="cpu")
    jX, jY, tX, tY = jnp.asarray(X), jnp.asarray(Y), torch.tensor(X), torch.tensor(Y)
    return (lambda p: -jsgp.elbo(cfg, p, jX, jY)), jp, (lambda p: -tsgp.elbo(tcfg, p, tX, tY)), tp


def test_fit_scg_matches_jax(corpus):
    jloss, jp, tloss, tp = _sgp_problem(corpus)
    ref = jtrain.fit_scg(jloss, jp, iters=30)
    ours = train.fit_scg(tloss, tp, iters=30)
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    _close(ours.params, ref.params, 1e-8)
    assert (np.diff(ours.losses.numpy()) <= 0).all()


def test_fit_scipy_lbfgs_matches_jax(corpus):
    jloss, jp, tloss, tp = _sgp_problem(corpus)
    ref = jtrain.fit_scipy_lbfgs(jloss, jp, max_iters=40)
    ours = train.fit_scipy_lbfgs(tloss, tp, max_iters=40)
    np.testing.assert_allclose(float(ours.losses[-1]), float(ref.losses[-1]), rtol=1e-6)
    assert float(ours.losses[-1]) < float(ours.losses[0])


def test_optimize_restarts_matches_jax():
    """tests/test_utils.py's tilted double well: the deeper negative basin
    wins on the raw loss, and ``accept_fn`` vetoes it; the kept restart's
    parameters and losses agree with the JAX package's."""

    def loss(lib):
        return lambda p: ((p["x"] ** 2 - 1.0) ** 2 + 0.1 * p["x"]).sum()

    def init(lib):
        return lambda seed: {"x": lib.asarray([float(seed) * 2.0 - 2.5], dtype=lib.float64)}

    kw = dict(iters=500, learning_rate=0.05)
    for accept in (None, "positive"):
        ref = jtrain.optimize_restarts(loss(jnp), init(jnp), range(4), **kw,
                                       accept_fn=None if accept is None else (lambda p: jnp.all(p["x"] > 0)))
        ours = train.optimize_restarts(loss(torch), init(torch), range(4), **kw,
                                       accept_fn=None if accept is None else (lambda p: (p["x"] > 0).all()))
        assert (float(ours.params["x"][0]) > 0) == (accept is not None)
        np.testing.assert_allclose(ours.params["x"].numpy(), np.asarray(ref.params["x"]), rtol=1e-8)
        np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-8)
    # every restart vetoed: the least final loss wins regardless
    ours = train.optimize_restarts(loss(torch), init(torch), range(4), **kw, accept_fn=lambda p: False)
    assert float(ours.params["x"][0]) < 0


def test_fit_adam_on_a_vector_loss_trains_each_instance_as_alone():
    """A loss of shape (R,) (``torch.func.vmap`` over instances stacked by
    ``stack_restarts``), with an ``aux_fn`` refresh: each instance's losses
    and parameters equal its own ``fit_adam`` (float64, rtol 1e-12), and the
    losses are (iters, R). The restart paths (``optimize_restarts``,
    ``config1.fit_batched``) train through this."""
    tl = _quadratic(torch)
    inits = [{"x": torch.tensor(np.linspace(0.1, 0.9, 6).reshape(2, 3) * (1 + r)),
              "y": torch.tensor([1.5 - r, -0.5 + 0.3 * r])} for r in range(3)]
    kw = dict(iters=7, learning_rate=train.cosine_decay_schedule(0.05, 7, 0.01), aux_every=3)

    def loss(p, a):
        return tl(p) * a

    def aux(p):
        return 1.0 + 0.1 * p["y"].sum(-1)

    batched = train.fit_adam(torch.func.vmap(loss), train.stack_restarts(inits), aux_fn=aux, **kw)
    assert batched.losses.shape == (7, 3)
    for r, p in enumerate(inits):
        alone = train.fit_adam(loss, p, aux_fn=aux, **kw)
        np.testing.assert_allclose(batched.losses[:, r].numpy(), alone.losses.numpy(), rtol=1e-12)
        for (path, a), (_, b) in zip(train.leaves_with_paths(train.restart(batched.params, r)),
                                     train.leaves_with_paths(alone.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14, err_msg=path)


def test_fit_adam_runs_exactly_iters_where_jax_pads_the_last_chunk():
    """ROADMAP.md Queue 3: with ``aux_fn`` and ``iters`` not a multiple of
    ``aux_every``, the JAX package's ``fit_adam`` runs whole chunks and keeps
    only the first ``iters`` losses, so its parameters are those after
    ceil(iters / aux_every) * aux_every updates. The port runs ``iters``."""
    x0 = np.linspace(0.1, 0.9, 6).reshape(2, 3)
    y0 = np.array([1.5, -0.5])
    pj = {"x": jnp.asarray(x0), "y": jnp.asarray(y0)}
    pt = {"x": torch.tensor(x0), "y": torch.tensor(y0)}
    jl, tl = _quadratic(jnp), _quadratic(torch)
    ref = jtrain.fit_adam(lambda p, a: jl(p), pj, iters=3, learning_rate=0.05, aux_fn=lambda p: 0.0, aux_every=10)
    ours3 = train.fit_adam(lambda p, a: tl(p), pt, iters=3, learning_rate=0.05, aux_fn=lambda p: 0.0, aux_every=10)
    ours10 = train.fit_adam(tl, pt, iters=10, learning_rate=0.05)
    assert np.asarray(ref.losses).shape == (3,)
    np.testing.assert_allclose(ours3.losses.numpy(), np.asarray(ref.losses), rtol=1e-10)
    _close(ours10.params, ref.params, 1e-10)
    assert not np.allclose(ours3.params["x"].numpy(), np.asarray(ref.params["x"]))
