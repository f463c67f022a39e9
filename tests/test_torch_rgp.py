"""The serving slice as a whole: rgp_tpu_torch.models.rgp against
rgp_tpu.models.rgp on the CPU.

* data and init are numpy in both packages: array-equal;
* the f64 ELBO at the golden setup equals the golden value at rtol 1e-8
  (tests/test_golden_regression.py);
* from the same carried-over, perturbed weights, predict_train and a 32-step
  freerun match the JAX package at rtol 1e-7 (rounding of two LAPACK builds
  compounded over the closed loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.data import datasets as jd
from rgp_tpu.data.windows import Standardizer as JStandardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch import kernels as tk
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.data import datasets as td
from rgp_tpu_torch.data import windows as tw
from rgp_tpu_torch.models import encoder as tenc
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.utils import checkpoint

_GOLDEN_E0 = -5946.347076392082  # tests/test_golden_regression.py


def _jax_data(dtype=jnp.float64):
    d = jd.actuator()
    sy, su = JStandardizer.fit(d.y_train), JStandardizer.fit(d.u_train)
    return (jnp.asarray(sy.transform(d.y_train), dtype), jnp.asarray(su.transform(d.u_train), dtype),
            jnp.asarray(su.transform(d.u_test), dtype))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.cpu()) if torch.is_tensor(tree) else np.asarray(tree)]


@pytest.mark.parametrize("name", ["actuator", "drives"])
def test_datasets_array_equal(name):
    ours, ref = td.load(name), jd.load(name)
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    t = td.standardized_tensors(ours, dtype=torch.float64, device="cpu")
    sy = JStandardizer.fit(ref.y_train)
    np.testing.assert_array_equal(t.Y.numpy(), sy.transform(ref.y_train))
    np.testing.assert_array_equal(t.Y_test.numpy(), sy.transform(ref.y_test))


def test_windows_match_jax(rng):
    from rgp_tpu.data import windows as jw

    X = rng.standard_normal((9, 2))
    for L in (1, 3):
        np.testing.assert_array_equal(tw.lagged(torch.tensor(X), L).numpy(), np.asarray(jw.lagged(X, L)))
        np.testing.assert_array_equal(tw.current_window(torch.tensor(X), L).numpy(),
                                      np.asarray(jw.current_window(X, L)))
        np.testing.assert_array_equal(tw.np_lagged(X, L), jw.np_lagged(X, L))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_params_array_equal(dtype):
    Y, U, _ = _jax_data(getattr(jnp, dtype))
    cfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    tcfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    ref = jr.init_params(cfg, Y, U, seed=0, dtype=getattr(jnp, dtype))
    ours = tr.init_params(tcfg, torch.tensor(np.asarray(Y)), torch.tensor(np.asarray(U)), seed=0,
                          dtype=getattr(torch, dtype), device="cpu")
    a, b = _leaves(ours), _leaves(ref)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("block", [None, 128])
def test_golden_elbo_f64(block):
    d = td.standardized_tensors(td.actuator(), dtype=torch.float64, device="cpu")
    cfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    params = tr.init_params(cfg, d.Y, d.U, dtype=torch.float64, seed=0, device="cpu")
    with torch.no_grad():
        e0 = float(tr.elbo(cfg, params, d.Y, d.U, block=block))
    np.testing.assert_allclose(e0, _GOLDEN_E0, rtol=1e-8)


@pytest.fixture(scope="module")
def carried():
    """A JAX init at M=20 perturbed by seeded numpy noise, and its carry-over."""
    Y, U, Ut = _jax_data()
    cfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=20)
    tcfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=20)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)),
                      jr.init_params(cfg, Y, U, dtype=jnp.float64, seed=0))
    tp = params_from_jax(jp, dtype=torch.float64, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return cfg, tcfg, jp, tp, (Y, U, Ut), (t(Y), t(U), t(Ut))


def test_params_from_jax_keeps_every_leaf(carried):
    _, _, jp, tp, _, _ = carried
    for x, y in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_array_equal(x, y)


def test_elbo_matches_jax(carried):
    cfg, tcfg, jp, tp, (Y, U, _), (tY, tU, _) = carried
    j_elbo = jax.jit(jr.elbo, static_argnums=0, static_argnames="block")
    np.testing.assert_allclose(float(tr.elbo(tcfg, tp, tY, tU, block=None)),
                               float(j_elbo(cfg, jp, Y, U, block=None)), rtol=1e-9)


@pytest.mark.parametrize("chol_jitter", [1e-3, None])
@pytest.mark.parametrize("psi_prefer", ["auto", "scan"])
def test_elbo_jitter_and_dispatch_match_jax(carried, chol_jitter, psi_prefer):
    """The sampler potential's arguments: a base jitter for the whitened
    Cholesky ladders and the Psi2 dispatch, chunked (block 128 over T=512)."""
    cfg, tcfg, jp, tp, (Y, U, _), (tY, tU, _) = carried
    j_elbo = jax.jit(jr.elbo, static_argnums=0, static_argnames=("block", "psi_prefer", "chol_jitter"))
    ours = tr.elbo(tcfg, tp, tY, tU, block=128, psi_prefer=psi_prefer, chol_jitter=chol_jitter)
    ref = j_elbo(cfg, jp, Y, U, block=128, psi_prefer=psi_prefer, chol_jitter=chol_jitter)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-9)


def test_elbo_chol_jitter_changes_the_bound(carried):
    """A larger base rung shifts the bound (a uniform ~O(0.1-1) nat shift in
    the reference), so the override is really applied."""
    _, tcfg, _, tp, _, (tY, tU, _) = carried
    e0 = float(tr.elbo(tcfg, tp, tY, tU, block=None))
    e1 = float(tr.elbo(tcfg, tp, tY, tU, block=None, chol_jitter=1e-3))
    assert e0 != e1


@pytest.mark.parametrize("ladder", [True, False])
def test_compute_whitenings_match_jax(carried, ladder):
    cfg, tcfg, jp, tp, (Y, U, _), (tY, tU, _) = carried
    j_whiten = jax.jit(jr.compute_whitenings, static_argnums=0, static_argnames=("block", "ladder"))
    ours = tr.compute_whitenings(tcfg, tp, tY, tU, block=None, ladder=ladder)
    ref = j_whiten(cfg, jp, Y, U, block=None, ladder=ladder)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a.half_logdet), float(b.half_logdet), rtol=1e-9)
        np.testing.assert_allclose(a.topup.numpy(), np.asarray(b.topup), rtol=1e-7, atol=1e-12)


def test_predict_train_matches_jax(carried):
    cfg, tcfg, jp, tp, (Y, U, _), (tY, tU, _) = carried
    for a, b in zip(tr.predict_train(tcfg, tp, tY, tU), jr.predict_train(cfg, jp, Y, U)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


def test_freerun_matches_jax(carried):
    cfg, tcfg, jp, tp, (Y, U, Ut), (tY, tU, tUt) = carried
    ours = tr.freerun(tcfg, tp, tY, tU, tUt[:32])
    ref = jr.freerun(cfg, jp, Y, U, Ut[:32])
    for a, b in zip(ours, ref):
        assert a.shape == (32, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


@pytest.mark.parametrize("entry", ["init_params", "standardized_tensors", "params_from_jax",
                                   "init_mlp", "RBF.init", "Matern52.init", "StdPeriodic.init",
                                   "MLP.init", "Sum.init", "load_checkpoint"])
def test_constructors_do_not_fall_back_to_cpu(entry, carried, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None builds there")
    _, tcfg, jp, _, _, (tY, tU, _) = carried
    calls = {
        "init_params": lambda: tr.init_params(tcfg, tY, tU),
        "standardized_tensors": lambda: td.standardized_tensors(td.actuator()),
        "params_from_jax": lambda: params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64),
        "init_mlp": lambda: tenc.init_mlp(torch.Generator().manual_seed(0), (3, 4, 2)),
        "RBF.init": lambda: tk.RBF(input_dim=2).init(),
        "Matern52.init": lambda: tk.Matern52(input_dim=2).init(),
        "StdPeriodic.init": lambda: tk.StdPeriodic(input_dim=2).init(),
        "MLP.init": lambda: tk.MLP(input_dim=2).init(),
        "Sum.init": lambda: (tk.Linear(input_dim=2) + tk.Bias(input_dim=2)).init(),
        "load_checkpoint": lambda: checkpoint.load_checkpoint(str(tmp_path)),
    }
    if entry == "load_checkpoint":  # a real checkpoint, so only the device can stop the load
        checkpoint.save_checkpoint(str(tmp_path), {"x": torch.zeros(2)}, step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("amortize_var", [False, True])
def test_back_constrained_config_builds_encoder(amortize_var):
    """A back_cstr config builds, and init_params makes one MLP per hidden
    layer of shape (win*y_dim + u_win*u_dim, *mlp_hidden, q_dim*(1 or 2)),
    zero biases, from the seed."""
    d = td.standardized_tensors(td.drives(T=64), dtype=torch.float64, device="cpu")
    cfg = tr.deep_rgp_config(wins=[0, 3, 2], u_win=4, y_dim=1, u_dim=1, num_inducing=8,
                             q_dims=[2, 1], back_cstr=True, mlp_hidden=(5, 6),
                             amortize_var=amortize_var)
    params = tr.init_params(cfg, d.Y, d.U, seed=3, dtype=torch.float64, device="cpu")
    enc = params["encoder"]
    assert len(enc) == cfg.n_hidden == 2
    k = 2 if amortize_var else 1
    for spec, mlp in zip(cfg.layers, enc):
        dims = (spec.win * 1 + 4 * 1, 5, 6, spec.q_dim * k)
        assert [tuple(layer["w"].shape) for layer in mlp] == list(zip(dims[:-1], dims[1:]))
        for layer in mlp:
            assert layer["w"].dtype == torch.float64 and not layer["b"].any()
            assert layer["w"].std() > 0
    again = tr.init_params(cfg, d.Y, d.U, seed=3, dtype=torch.float64, device="cpu")["encoder"]
    assert all(torch.equal(a["w"], b["w"]) for x, y in zip(enc, again) for a, b in zip(x, y))
    assert "encoder" not in tr.init_params(tr.deep_rgp_config(wins=[0, 3], u_win=4, y_dim=1, u_dim=1,
                                                               num_inducing=8),
                                            d.Y, d.U, dtype=torch.float64, device="cpu")
