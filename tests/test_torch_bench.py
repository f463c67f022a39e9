"""rgp_tpu_torch.bench.config1 against the root bench.py on the CPU: the same
standardized data, and the same restart picked by the degeneracy guard and
the MAD screen.

bench.py's guard sits inside ``_fit_restarts`` after a vmapped fit. The
restart test runs that function itself with the fit replaced by hand-made
final ELBOs and noise values (``jax.vmap`` patched for the call), so the
reference is bench.py's own selection code, not a copy of it.

``config1.fit_restarts`` (restarts trained as one batch) against
``bench._fit_restarts`` itself, unpatched, in float64 on config 1 cut small
(T=128, M=16, 4 seeds, 200 steps, two whitening refreshes): every final
ELBO at rtol 1e-6 (the golden trajectory's gate) and the same restart kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rgp_tpu.data import datasets as jd
from rgp_tpu.data.windows import Standardizer
from rgp_tpu.models import rgp as jr
from rgp_tpu_torch.bench import config1
from rgp_tpu_torch.models import rgp as tr

_R, _T, _Q = 5, 7, 1


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_fit_restarts_matches_bench():
    T, M, seeds, iters = 128, 16, range(4), 200
    d = jd.actuator()
    Y = Standardizer.fit(d.y_train).transform(d.y_train)[:T]
    U = Standardizer.fit(d.u_train).transform(d.u_train)[:T]
    kw = dict(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=M)
    ref_p, ref_e = bench._fit_restarts(jr.deep_rgp_config(**kw), jnp.asarray(Y), jnp.asarray(U), iters, 1e-2,
                                       seeds, jnp.float64)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours_p, ours_e = config1.fit_restarts(tr.deep_rgp_config(**kw), torch.tensor(Y), torch.tensor(U), iters,
                                              1e-2, seeds)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(ours_e, ref_e, rtol=1e-6)
    # the kept restart: its parameters are bench.py's kept ones (another
    # restart's differ at O(1))
    for a, b in zip(_leaves(ours_p), _leaves(ref_p)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def test_setup_matches_bench():
    cfg, params, Y, U, Ut, sy, d = config1.setup(torch.float32, device="cpu")
    _, jparams, jY, jU, jUt, jsy, jd = bench._setup(jnp.float32)
    for a, b in ((Y, jY), (U, jU), (Ut, jUt)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sy.mean, jsy.mean)
    np.testing.assert_array_equal(sy.std, jsy.std)
    np.testing.assert_array_equal(params["layers"][0]["Z"].numpy(), np.asarray(jparams["layers"][0]["Z"]))
    assert cfg.layers[0].num_inducing == 100 and cfg.layers[0].kernel.input_dim == 20


_CASES = {
    # final ELBOs, per-restart hidden-layer log_noise, per-restart log_lam
    # level, and the restart bench.py keeps
    "all_healthy": ([-200.0, -150.0, -180.0, -160.0, -210.0], [-3.0] * 5, [-4.0] * 5, 1),
    "best_noise_collapsed": ([-200.0, -150.0, -180.0, -160.0, -210.0],
                             [-3.0, -30.0, -3.0, -3.0, -3.0], [-4.0] * 5, 3),
    "best_variance_collapsed": ([-200.0, -150.0, -180.0, -160.0, -210.0], [-3.0] * 5,
                                [-4.0, -12.0, -4.0, -4.0, -4.0], 3),
    "mad_outlier": ([-200.0, 2200.0, -180.0, -160.0, -210.0], [-3.0] * 5, [-4.0] * 5, 3),
    "all_rejected": ([-200.0, -150.0, -180.0, -160.0, -210.0], [-30.0] * 5, [-4.0] * 5, 1),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_restart_guard_matches_bench(case, monkeypatch):
    *arrays, want = _CASES[case]
    elbos, log_noise, log_lam = (np.asarray(x, np.float64) for x in arrays)
    d = jd.actuator()
    Y = jnp.asarray(Standardizer.fit(d.y_train).transform(d.y_train)[:40], jnp.float32)
    U = jnp.asarray(Standardizer.fit(d.u_train).transform(d.u_train)[:40], jnp.float32)
    jcfg = jr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    params_b = {"layers": [{
        "log_noise": jnp.asarray(log_noise, jnp.float32),
        "log_lam": jnp.asarray(np.broadcast_to(log_lam[:, None, None], (_R, _T, _Q)), jnp.float32),
        "restart": jnp.arange(_R),
    }]}
    final_b = jnp.asarray(-elbos, jnp.float32)
    monkeypatch.setattr(jax, "vmap", lambda run_one: (lambda stacked: (params_b, final_b)))
    p_best, _ = bench._fit_restarts(jcfg, Y, U, 100, 1e-2, range(_R), jnp.float32)
    ref = int(p_best["layers"][0]["restart"])
    assert ref == want

    cfg = tr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    params_list = [{"layers": [{
        "log_noise": torch.tensor(log_noise[r], dtype=torch.float32),
        "log_lam": torch.full((_T, _Q), log_lam[r], dtype=torch.float32),
    }]} for r in range(_R)]
    assert config1.select_restart(cfg, elbos.astype(np.float32), params_list) == ref
