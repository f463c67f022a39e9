"""rgp_tpu_torch.bench.serving against rgp_tpu.bench.serving on the CPU.

The model is config 1's shape cut small: actuator's first 64 training steps,
``wins=[0, 10]``, ``u_win=10``, M=8, at ``init_params(seed=0)``; the test
horizon is 32 steps. Both packages get it through their ``_flagship`` seam.

* the vmapped freerun over 2 perturbed input sequences equals 2 single
  freeruns at rtol 1e-10 (float64; the batched ops round otherwise), and
  its first sequence equals JAX's ``rgp.freerun`` on the same inputs at rtol
  1e-7 (tests/test_torch_rgp.py's tolerance: two LAPACK builds compounded
  over the closed loop);
* the record has the JAX benchmark's keys, ``details`` also the card.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import sampling as jsampling
from rgp_tpu.bench import serving as jserving
from rgp_tpu.data import datasets as jdatasets
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch.bench import serving as tserving
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import rgp as tr

T, T_STAR, M = 64, 32, 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Many small ops: one intra-op thread, restored after the test (the
    test workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype):
    """(cfg, params, Y, U, U_test, Y_test) as the JAX ``_flagship`` returns
    them, cut small."""
    d = jdatasets.load("actuator")
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    Y = jnp.asarray(sy.transform(d.y_train)[:T], dtype)
    U = jnp.asarray(su.transform(d.u_train)[:T], dtype)
    Ut = jnp.asarray(su.transform(d.u_test)[:T_STAR], dtype)
    Yt = jnp.asarray(sy.transform(d.y_test)[:T_STAR], dtype)
    cfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=M)
    return cfg, jr.init_params(cfg, Y, U, dtype=dtype), Y, U, Ut, Yt


def _torch_model(dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    cfg, params, Y, U, Ut, Yt = _jax_model(jdtype)
    tcfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=M)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    tp = params_from_jax(jax.tree.map(np.array, params), dtype=dtype, device="cpu")
    return tcfg, tp, t(Y), t(U), t(Ut), t(Yt)


def test_vmapped_freerun_equals_single_freeruns_and_jax():
    cfg, params, Y, U, Ut, _ = _torch_model(torch.float64)
    Us = tserving.perturbed_inputs(Ut, 2)
    assert Us.shape == (2, T_STAR, 1) and not torch.equal(Us[0], Us[1])
    means, variances = tserving.batched_freerun(cfg, params, Y, U, Us)
    assert means.shape == variances.shape == (2, T_STAR, 1)
    for b in range(2):
        with torch.no_grad():
            m, v = tr.freerun(cfg, params, Y, U, Us[b])
        np.testing.assert_allclose(means[b].numpy(), m.numpy(), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(variances[b].numpy(), v.numpy(), rtol=1e-10, atol=1e-14)
    jcfg, jp, jY, jU, _, _ = _jax_model(jnp.float64)
    ref = jr.freerun(jcfg, jp, jY, jU, jnp.asarray(Us[0].numpy()))
    for ours, theirs in zip((means[0], variances[0]), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-7)


def test_record_has_the_jax_benchmarks_keys(monkeypatch, capsys):
    monkeypatch.setattr(jsampling, "_flagship", lambda fit_iters, dtype, *a, **k: _jax_model(dtype))
    jserving.main(["--repeat", "1", "--batch", "2"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = tserving.serve(_torch_model(torch.float32), repeat=1, batch=2)
    assert sorted(ours) == sorted(ref)
    assert sorted(ours["details"]) == sorted(set(ref["details"]) | {"card"})
    assert ours["metric"] == ref["metric"] == f"freerun_steps_per_sec[rgp1L_actuator_M100_T{T_STAR}]"
    d = ours["details"]
    assert d["backend"] == "cpu" and d["card"] is None and d["horizon_steps"] == T_STAR
    assert d["batched_serving_width"] == 2 and d["moment_matched"] is True
    assert all(np.isfinite(d[k]) and d[k] > 0 for k in ("freerun_latency_ms", "onestep_predict_latency_ms",
                                                         "batched_serving_steps_per_sec"))


def test_command_line_is_the_jax_benchmarks():
    from test_torch_sampling_bench import _options

    for argv in ([], ["--fit-iters", "0", "--repeat", "3", "--batch", "64"]):
        assert _options(tserving.main, argv) == _options(jserving.main, argv)


def test_main_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tserving.main(["--repeat", "1"])
