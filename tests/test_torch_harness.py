"""rgp_tpu_torch.bench.harness against rgp_tpu.bench.harness on the CPU in
float64: the same task, method, budget and seed in both packages. The inits
are numpy in both, so the runs start from the same point and their
elbo_first, elbo_last and freerun_rmse agree at rtol 1e-6; the JSON keys are
the same.

Config 4's five routes run on long_corpus cut to T=2048 (train 1536, test 512;
the cut keeps the 512-step freeruns cheap) at M=20 and batch 64, with the
JAX draws (``jax.random.split``/``randint`` from ``PRNGKey(seed)``) replayed
into the port's ``indices``. ``gp_narx_collapsed`` runs 100 steps, a whole
whitening chunk: at 3 the JAX ``fit_adam`` would apply 100 updates and report
3 losses (ROADMAP.md Queue 3).

The JAX harness's methods call ``init_params`` without a dtype, i.e. in
float32; the fixture ``f64`` hands them their data's dtype, so its float64
runs are float64 throughout, as the port's are.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import harness as jh
from rgp_tpu.models import gp_narx as jnarx
from rgp_tpu.models import rgp as jr
from rgp_tpu.models import sparse_gp as jsgp
from rgp_tpu.models import svgp as jsvgp
from rgp_tpu_torch.bench import harness as th

RUNS = {
    "drives_rgp2": ("drives", "rgp2"),
    "actuator_gp_narx": ("actuator", "gp_narx"),
}


@pytest.fixture
def f64(monkeypatch):
    for mod in (jr, jnarx, jsgp, jsvgp):
        monkeypatch.setattr(mod, "init_params",
                            lambda cfg, Y, *a, _init=mod.init_params, **kw: _init(cfg, Y, *a, **{**kw, "dtype": Y.dtype}))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax(name, f64):
    task, method = RUNS[name]
    ours = th.run(task, method, iters=3, num_inducing=8, dtype=torch.float64, device="cpu")
    ref = jh.run(task, method, iters=3, num_inducing=8, dtype=jnp.float64)
    assert set(ours) == set(ref)
    for key in ("task", "method", "iters", "restarts", "select", "steady", "zero_predictor_rmse",
                "degenerate_reasons"):
        assert ours[key] == ref[key], key
    for key in ("elbo_first", "elbo_last", "freerun_rmse"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, err_msg=key)
    assert ours["backend"] == "cpu" and ours["elbo_last"] > ours["elbo_first"]


def test_restarts_select_the_same_seed_as_jax(f64):
    """Two restarts scored by the rollout on the training tail."""
    kw = dict(iters=2, num_inducing=6, restarts=2, select="rollout")
    ours = th.run("actuator", "gp_narx_matern", dtype=torch.float64, device="cpu", **kw)
    ref = jh.run("actuator", "gp_narx_matern", dtype=jnp.float64, **kw)
    assert [r["seed"] for r in ours["restart_table"]] == [0, 1]
    for a, b in zip(ours["restart_table"], ref["restart_table"]):
        np.testing.assert_allclose(a["elbo"], b["elbo"], rtol=1e-6)
        np.testing.assert_allclose(a["val_rollout_rmse"], b["val_rollout_rmse"], rtol=1e-6)
    np.testing.assert_allclose(ours["freerun_rmse"], ref["freerun_rmse"], rtol=1e-6)


CONFIG4 = {"svgp_natgrad": 3, "svgp_natgrad_collapsed": 3, "gp_narx_minibatch": 3, "gp_narx_minibatch_ema": 3,
           "gp_narx_collapsed": 100}


@pytest.mark.parametrize("method", sorted(CONFIG4))
def test_config4_route_matches_jax(method, f64, monkeypatch):
    for mod in (jh, th):
        monkeypatch.setitem(mod.TASKS, "long_corpus", functools.partial(mod.TASKS["long_corpus"], T=2048))
    iters, bs, seed = CONFIG4[method], 64, 0
    n = 2048 * 3 // 4 - 10  # the NARX design's rows (y_win 10)
    idx = np.stack([np.asarray(jax.random.randint(k, (bs,), 0, n))
                    for k in jax.random.split(jax.random.PRNGKey(seed), iters)])
    ref = jh.run("long_corpus", method, iters=iters, num_inducing=20, dtype=jnp.float64, batch_size=bs)
    ours = th.run("long_corpus", method, iters=iters, num_inducing=20, dtype=torch.float64, device="cpu",
                  batch_size=bs, indices=torch.tensor(idx))
    assert set(ours) == set(ref) and ours["method_kw"] == ref["method_kw"] == {"batch_size": bs}
    for key in ("elbo_first", "elbo_last", "freerun_rmse"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, err_msg=key)
    assert ours["zero_predictor_rmse"] == ref["zero_predictor_rmse"]
    assert ours["degenerate_reasons"] == ref["degenerate_reasons"]
    assert ours["final_noise_min"] == ref["final_noise_min"]


def test_methods_are_the_jax_harness_minus_config4():
    """Since config 4's routes came, the port's methods are all the JAX harness's."""
    assert set(th.METHODS) == set(jh.METHODS)
    assert set(th.TASKS) == set(jh.TASKS)
    with pytest.raises(KeyError):
        th.run("actuator", "no_such_method", device="cpu")


def test_return_fit_is_the_kept_run():
    """``run(return_fit=True)`` hands back the fit its record scores: the same
    losses, the test-split freerun it scored, and the config and loss it
    trained."""
    rec, fit = th.run("actuator", "gp_narx", iters=3, num_inducing=6, dtype=torch.float64, device="cpu",
                      return_fit=True)
    assert isinstance(fit, th.MethodFit) and isinstance(fit.cfg, th.gp_narx.NARXConfig)
    losses = fit.res.losses.numpy()
    assert losses.shape == (3,)
    np.testing.assert_allclose([-losses[0], -losses[-1]], [rec["elbo_first"], rec["elbo_last"]], atol=5e-3)
    assert fit.means.shape == fit.vars.shape and bool((fit.vars > 0).all())
    assert rec["freerun_rmse"] == th.run("actuator", "gp_narx", iters=3, num_inducing=6, dtype=torch.float64,
                                         device="cpu")["freerun_rmse"]
    assert torch.isfinite(fit.loss(fit.res.params))
