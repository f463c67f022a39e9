"""rgp_tpu_torch.bench.harness against rgp_tpu.bench.harness on the CPU in
float64: the same task, method, budget and seed in both packages. The inits
are numpy in both, so the runs start from the same point and their
elbo_first, elbo_last and freerun_rmse agree at rtol 1e-6; the JSON keys are
the same. The config-4 routes are not ported and raise.

The JAX harness's methods call ``init_params`` without a dtype, i.e. in
float32; the fixture ``f64`` hands them Y's dtype, so its float64 runs are
float64 throughout, as the port's are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import harness as jh
from rgp_tpu.models import gp_narx as jnarx
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch.bench import harness as th

RUNS = {
    "drives_rgp2": ("drives", "rgp2"),
    "actuator_gp_narx": ("actuator", "gp_narx"),
}


@pytest.fixture
def f64(monkeypatch):
    for mod in (jr, jnarx):
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


@pytest.mark.parametrize("method", sorted(th.NOT_PORTED))
def test_config4_methods_raise(method):
    assert method in jh.METHODS
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12"):
        th.run("actuator", method, iters=1, device="cpu")


def test_methods_are_the_jax_harness_minus_config4():
    assert set(th.METHODS) == set(jh.METHODS) - set(th.NOT_PORTED)
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
