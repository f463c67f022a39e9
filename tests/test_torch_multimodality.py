"""rgp_tpu_torch.bench.multimodality against rgp_tpu.bench.multimodality on
the CPU, on config 1 cut small: actuator's first 64 training steps and 32
test steps, M=8 (``datasets.load`` and ``deep_rgp_config`` patched in both
packages).

* the restart-batched step (``vmap`` of ``-rgp.elbo`` over stacked restarts
  at their stacked whitenings, one gradient of the sum, one Adam step on the
  stacked leaves) equals each restart's own step, float64, rtol 1e-10;
* both packages' ``run`` at 2 restarts, 100 steps, chunk 100, in float32:
  the same CSV columns and summary keys, and per-restart ELBOs and RMSEs
  within rtol 1e-3 (``_RTOL``; float32 over 100 Adam steps in two
  packages: measured 4.2e-5 and 1.3e-4), the trained noises, q(X)
  variances and lengthscales within rtol 1e-2 (``_STATE_RTOL``: the output
  layer's lengthscale ends 1.8e-3 apart, the other columns within 4.7e-4;
  no ladder rung flipped in this run). The gaps are printed;
* ``chunk`` must be a multiple of 100 and divide ``iters``.
"""

import csv
import json

import numpy as np
import pytest
import torch

from rgp_tpu.bench import multimodality as jmm
from rgp_tpu.data import datasets as jdatasets
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch import train
from rgp_tpu_torch.bench import multimodality as tmm
from rgp_tpu_torch.data import datasets as tdatasets
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.params import leaves_with_paths, with_leaves

T, T_STAR, M = 64, 32, 8
_RTOL = 1e-3  # per-restart ELBO and RMSE, float32, between the packages
_STATE_RTOL = 1e-2  # the per-restart state columns


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(load):
    def cut(name, **kw):
        d = load(name, **kw)
        return d._replace(u_train=d.u_train[:T], y_train=d.y_train[:T], u_test=d.u_test[:T_STAR],
                          y_test=d.y_test[:T_STAR])
    return cut


def _small(config):
    return lambda *a, **kw: config(*a, **{**kw, "num_inducing": M})


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jdatasets, "load", _cut(jdatasets.load))
    monkeypatch.setattr(tdatasets, "load", _cut(tdatasets.load))
    monkeypatch.setattr(jr, "deep_rgp_config", _small(jr.deep_rgp_config))
    monkeypatch.setattr(tr, "deep_rgp_config", _small(tr.deep_rgp_config))


def test_restart_batched_step_equals_each_restarts_step(small):
    t = tdatasets.standardized_tensors(tdatasets.load("actuator"), dtype=torch.float64, device="cpu")
    cfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1)
    singles = [tr.init_params(cfg, t.Y, t.U, seed=s, dtype=torch.float64, device="cpu") for s in range(3)]
    stacked = tmm.stack_restarts(singles)
    leaves = [x.clone().requires_grad_() for _, x in leaves_with_paths(stacked)]
    wh = tmm.restart_whitenings(cfg, stacked, t.Y, t.U)
    losses = tmm.restart_losses(cfg, with_leaves(stacked, leaves), t.Y, t.U, wh)
    grads = torch.autograd.grad(losses.sum(), leaves)
    train.OptaxAdam(leaves, 1e-2).step(grads, 0)
    for r, p in enumerate(singles):
        with torch.no_grad():
            wh_r = tr.compute_whitenings(cfg, p, t.Y, t.U, block=None)
        for a, b in zip(wh_r, wh):
            np.testing.assert_allclose(b.W[r].numpy(), a.W.numpy(), rtol=1e-10, atol=1e-12)
        lv = [x.clone().requires_grad_() for _, x in leaves_with_paths(p)]
        loss = -tr.elbo(cfg, with_leaves(p, lv), t.Y, t.U, block=None, whitening=wh_r)
        g = torch.autograd.grad(loss, lv)
        np.testing.assert_allclose(losses[r].item(), loss.item(), rtol=1e-10)
        for gs, g1 in zip(grads, g):
            np.testing.assert_allclose(gs[r].numpy(), g1.numpy(), rtol=1e-10, atol=1e-10 * float(g1.abs().max()))
        train.OptaxAdam(lv, 1e-2).step(g, 0)
        for x, y in zip(leaves, lv):
            np.testing.assert_allclose(x[r].detach().numpy(), y.detach().numpy(), rtol=1e-10, atol=1e-12)


def test_run_matches_jax(small, tmp_path):
    ref = jmm.run(2, 100, 1e-2, 0, 100, str(tmp_path / "jax.csv"))
    ours = tmm.run(2, 100, 1e-2, 0, 100, str(tmp_path / "torch.csv"), device="cpu")
    assert sorted(ours) == sorted(ref)
    for k in ("corr_rmse", "good_vs_bad_medians"):
        assert sorted(ours[k]) == sorted(ref[k])
    assert ours["backend"] == "cpu" and ours["restarts"] == 2 and ours["iters"] == 100
    with open(tmp_path / "jax.csv") as f:
        jrows = list(csv.DictReader(f))
    with open(tmp_path / "torch.csv") as f:
        trows = list(csv.DictReader(f))
    assert list(trows[0]) == list(jrows[0]) and len(trows) == len(jrows) == 2
    gaps = {k: max(abs(float(a[k]) - float(b[k])) / abs(float(b[k])) for a, b in zip(trows, jrows))
            for k in jrows[0] if k != "seed"}
    print("relative gaps to JAX", json.dumps(gaps))
    for a, b in zip(trows, jrows):
        assert a["seed"] == b["seed"]
        for k in ("elbo", "rmse"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=_RTOL, err_msg=k)
        for k in set(b) - {"seed", "elbo", "rmse"}:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=_STATE_RTOL, err_msg=k)


def test_chunk_must_divide_the_run():
    with pytest.raises(ValueError, match="multiple of 100"):
        tmm.run(2, 300, 1e-2, 0, 150, "unused.csv", device="cpu")
    with pytest.raises(ValueError, match="divide iters"):
        tmm.run(2, 250, 1e-2, 0, 100, "unused.csv", device="cpu")
