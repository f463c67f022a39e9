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
