"""rgp_tpu_torch.bench.layer_step against rgp_tpu.bench.layer_step on the CPU.

The two losses ``run_shape`` times, (a) the full ``-rgp.elbo`` and (b) the
hidden and output collapsed bounds on pre-materialized windows, are built by
``layer_losses`` and held against the same losses built from ``rgp_tpu``'s
functions as its ``run_shape`` builds them: float64, T=64, M=8 (windows 4
and 4), values at rtol 1e-8 and gradients at rtol 1e-8 of each leaf's
largest entry, the output layer's leaves at 1e-6 (``_OUT_RTOL``): on this
problem the two packages' output-layer gradients part by ~1e-7 of the
leaf's largest in either loss, as on the sharding tests' problem
(ROADMAP.md Queue 3: small sums of large terms follow the order of the
Psi2 sum), while the hidden layer's agree to ~1e-14 and the q(X)
leaves to ~4e-9. ``run_shape``'s record has the JAX record's keys, and it
counts no K1/K2 launch on the CPU (two plain Psi2 sums a call instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import layer_step as jls
from rgp_tpu.data.windows import current_window as jcurrent_window
from rgp_tpu.inference.collapsed_vi import collapsed_bound as jcollapsed_bound
from rgp_tpu.models import rgp as jr
from rgp_tpu.ops.psi_stats import psi_statistics as jpsi_statistics
from rgp_tpu_torch.bench import layer_step as tls
from rgp_tpu_torch.models import rgp as tr
from rgp_tpu_torch.params import leaves_with_paths, with_leaves

T, M, WIN, U_WIN = 64, 8, 4, 4
_OUT_RTOL = 1e-6  # the output layer's gradients, of each leaf's largest (see the module note)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_losses(cfg, params, Y, U):
    """(full, bound_loss, (kp, op)) as rgp_tpu.bench.layer_step.run_shape
    builds them."""
    spec = cfg.layers[0]
    lp = params["layers"][0]
    mus, lams = jr._hidden_moments(cfg, params, Y, U)
    X_mu, X_s = jr._layer_inputs(cfg, 0, mus[0], lams[0], None, None, U)
    X_mu, X_s = jax.lax.stop_gradient(X_mu), jax.lax.stop_gradient(X_s)
    tgt_mu = jax.lax.stop_gradient(mus[0][spec.win:])
    tgt_lam = jax.lax.stop_gradient(lams[0][spec.win:])
    Xo_mu = jax.lax.stop_gradient(jcurrent_window(tgt_mu, cfg.out_win))
    Xo_s = jax.lax.stop_gradient(jcurrent_window(tgt_lam, cfg.out_win))

    def bound_loss(both):
        kp, op = both
        stats = jpsi_statistics(spec.kernel, kp["kern"], kp["Z"], X_mu, X_s, block=128)
        t = jcollapsed_bound(spec.kernel, kp["kern"], kp["Z"], kp["log_noise"], stats, tgt_mu, tgt_lam)
        so = jpsi_statistics(cfg.out_kernel, op["kern"], op["Z"], Xo_mu, Xo_s, block=128)
        t = t + jcollapsed_bound(cfg.out_kernel, op["kern"], op["Z"], op["log_noise"], so, Y)
        return -t

    opar = params["out"]
    kp = {"kern": lp["kern"], "Z": lp["Z"], "log_noise": lp["log_noise"]}
    op = {"kern": opar["kern"], "Z": opar["Z"], "log_noise": opar["log_noise"]}
    return (lambda p: -jr.elbo(cfg, p, Y, U)), bound_loss, (kp, op)


def _problem():
    rng = np.random.default_rng(0)
    Yn, Un = rng.standard_normal((T, 1)), rng.standard_normal((T, 1))
    jcfg = jr.deep_rgp_config(wins=[0, WIN], u_win=U_WIN, y_dim=1, u_dim=1, num_inducing=M)
    jY, jU = jnp.asarray(Yn), jnp.asarray(Un)
    jp = jr.init_params(jcfg, jY, jU, seed=0, dtype=jnp.float64)
    tcfg = tr.deep_rgp_config(wins=[0, WIN], u_win=U_WIN, y_dim=1, u_dim=1, num_inducing=M)
    tY, tU = torch.tensor(Yn), torch.tensor(Un)
    tp = tr.init_params(tcfg, tY, tU, seed=0, dtype=torch.float64, device="cpu")
    for a, b in zip(leaves_with_paths(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))
    return (jcfg, jp, jY, jU), (tcfg, tp, tY, tU)


def _value_and_grads(loss, tree):
    leaves = [x.detach().clone().requires_grad_() for _, x in leaves_with_paths(tree)]
    val = loss(with_leaves(tree, leaves))
    return val.item(), [g.numpy() for g in torch.autograd.grad(val, leaves)]


@pytest.mark.parametrize("which", [0, 1], ids=["full_elbo", "premat_bounds"])
def test_layer_losses_match_jax(which):
    (jcfg, jp, jY, jU), (tcfg, tp, tY, tU) = _problem()
    jfull, jbound, jargs = _jax_losses(jcfg, jp, jY, jU)
    tfull, tbound, targs = tls.layer_losses(tcfg, tp, tY, tU)
    jloss, jtree = ((jfull, jp), (jbound, jargs))[which]
    tloss, ttree = ((tfull, tp), (tbound, targs))[which]
    ref_val, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtree)
    val, grads = _value_and_grads(tloss, ttree)
    np.testing.assert_allclose(val, float(ref_val), rtol=1e-8)
    ref_grads = [np.asarray(g) for g in jax.tree.leaves(ref_grads)]
    paths = [p for p, _ in leaves_with_paths(ttree)]
    assert len(grads) == len(ref_grads) == len(paths)
    for path, g, r in zip(paths, grads, ref_grads):
        tol = _OUT_RTOL if path.startswith(("out/", "1/")) else 1e-8
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * np.abs(r).max(), err_msg=path)


def test_run_shape_record():
    ref = jls.run_shape(T, M, WIN, U_WIN, iters=1)
    row = tls.run_shape(T, M, WIN, U_WIN, iters=2, device="cpu")
    assert set(ref) <= set(row)
    assert (row["T"], row["M"], row["Q"]) == (ref["T"], ref["M"], ref["Q"]) == (T, M, WIN + U_WIN)
    assert row["backend"] == "cpu" and row["card"] is None
    assert row["gather_overhead_pct"] == row["full_layer_step_device_ms"] == "not measured"
    assert np.isfinite(row["gather_overhead_pct_wall"])
    for loss in ("full", "premat"):
        assert row["launches_per_iter"][loss] == {"k1": 0.0, "k2": 0.0, "plain_psi2": 2.0}
