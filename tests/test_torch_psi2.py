"""K1 (rgp_tpu_torch.ops.cuda.psi2) and the port's psi statistics against
rgp_tpu on the CPU.

Tolerances: the plain K1 version in float32 against the Pallas kernel in
interpret mode at the Pallas tests' tolerance (rtol 2e-4, atol 2e-5,
tests/test_pallas.py); in float64 the T-split reduce changes only the
summation order (rtol 1e-10); psi01 / psi2_per_t are the same closed forms
(rtol 1e-12). K2's plain version and the autograd Function's gradients: the
Pallas backward tests' 3e-4 in float32 (tests/test_pallas.py), 1e-9 in
float64, where only the summation order differs. The CUDA kernels themselves
are held against the plain versions on the card by the tests marked ``cuda``
and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.kernels import RBF as JRBF
from rgp_tpu.ops import psi_stats as jps
from rgp_tpu.ops.pallas.psi2 import _psi2_bwd_raw, _psi2_pallas_raw
from rgp_tpu_torch.kernels import RBF
from rgp_tpu_torch.ops import psi_stats
from rgp_tpu_torch.ops.cuda import psi2

# one compile per shape instead of op-by-op dispatch of the reference
_jax_psi_statistics = jax.jit(jps.psi_statistics, static_argnums=0, static_argnames="block")


def _inputs(rng, T, M, Q, log_ls_shift=0.0):
    mu = rng.standard_normal((T, Q))
    s = rng.uniform(0.05, 0.4, (T, Q))
    Z = rng.standard_normal((M, Q))
    jp = JRBF(input_dim=Q).init(dtype=jnp.float64)
    jp = {k: v + (log_ls_shift if k == "log_ls" else 0.0) for k, v in jp.items()}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return mu, s, Z, jp, tp


def test_plain_k1_matches_pallas_interpret(rng):
    T, M, Q = 40, 24, 3
    mu, s, Z, jp, tp = _inputs(rng, T, M, Q)
    base, E, D1, w = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    args32 = [x.to(torch.float32).contiguous() for x in (base, E, D1, w, torch.tensor(Z))]
    ours = psi2.psi2_time_sum(*args32).numpy()  # CPU tensor -> the plain version
    ref = np.asarray(_psi2_pallas_raw(*[jnp.asarray(x.numpy()) for x in args32],
                                      bt=8, bm=64, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("T,M,Q", [(40, 24, 3), (65, 30, 5), (300, 7, 1)])
def test_plain_k1_f64_matches_psi_statistics(rng, T, M, Q):
    mu, s, Z, jp, tp = _inputs(rng, T, M, Q, log_ls_shift=0.5)
    ref = np.asarray(_jax_psi_statistics(JRBF(input_dim=Q), jp, jnp.asarray(Z), jnp.asarray(mu),
                                        jnp.asarray(s), block=None).psi2)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    assert psi2.t_split(T, M)[0] > 1  # the T-split reduce is exercised
    ours = psi2.psi2_time_sum_plain(*pre, torch.tensor(Z)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


@pytest.mark.parametrize("block", [None, 16])
def test_psi_statistics_matches_jax(rng, block):
    T, M, Q = 50, 13, 4
    mu, s, Z, jp, tp = _inputs(rng, T, M, Q, log_ls_shift=0.3)
    ref = _jax_psi_statistics(JRBF(input_dim=Q), jp, jnp.asarray(Z), jnp.asarray(mu),
                             jnp.asarray(s), block=None)
    ours = psi_stats.psi_statistics(RBF(input_dim=Q), tp, torch.tensor(Z), torch.tensor(mu),
                                    torch.tensor(s), block=block)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


def test_psi_statistics_certain_inputs_match_jax(rng):
    mu, _, Z, jp, tp = _inputs(rng, 30, 9, 2)
    ref = jps.psi_statistics(JRBF(input_dim=2), jp, jnp.asarray(Z), jnp.asarray(mu), None)
    ours = psi_stats.psi_statistics(RBF(input_dim=2), tp, torch.tensor(Z), torch.tensor(mu), None)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("active_dims", [None, (0, 2)])
def test_psi01_and_psi2_per_t_match_jax(rng, active_dims):
    T, M, Q = 6, 11, 3
    mu, s, Z, _, _ = _inputs(rng, T, M, Q)
    jk = JRBF(input_dim=len(active_dims or range(Q)), active_dims=active_dims)
    tk = RBF(input_dim=jk.input_dim, active_dims=active_dims)
    jp = jk.init(lengthscale=np.linspace(0.7, 1.6, jk.input_dim), dtype=jnp.float64)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    args_j = (jnp.asarray(Z), jnp.asarray(mu), jnp.asarray(s))
    args_t = (torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    for a, b in zip(psi_stats.psi01(tk, tp, *args_t), jps.psi01(jk, jp, *args_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    np.testing.assert_allclose(psi_stats.psi2_per_t(tk, tp, *args_t).numpy(),
                               np.asarray(jps.psi2_per_t(jk, jp, *args_j)), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_dispatch_takes_plain_path(rng, dtype):
    mu, s, Z, _, tp = _inputs(rng, 20, 6, 2)
    tp = {k: v.to(dtype) for k, v in tp.items()}
    psi2.launches = 0
    n0 = psi_stats.plain_psi2_calls
    psi_stats.psi_statistics(RBF(input_dim=2), tp, torch.tensor(Z, dtype=dtype),
                             torch.tensor(mu, dtype=dtype), torch.tensor(s, dtype=dtype))
    assert psi_stats.plain_psi2_calls == n0 + 1
    assert psi2.launches == 0


def test_plain_k2_matches_pallas_interpret(rng):
    T, M, Q = 40, 24, 3
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    G = rng.standard_normal((M, M))
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z), torch.tensor(G + G.T))]
    assert psi2.bwd_split(T, M)[0] > 1  # the ordered reduce over T ranges is exercised
    ours = psi2.psi2_time_sum_bwd(*args32)  # CPU tensors -> the plain version
    ref = _psi2_bwd_raw(*[jnp.asarray(x.numpy()) for x in args32], bt=8, bm=64, interpret=True)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4, atol=3e-4)


def _jax_psi2_grads(jp, Z, mu, s, G):
    Q = Z.shape[1]

    def f(p, Z_, mu_, s_):
        return jnp.sum(jps.psi_statistics(JRBF(input_dim=Q), p, Z_, mu_, s_, block=None).psi2 * G)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(jp, jnp.asarray(Z), jnp.asarray(mu), jnp.asarray(s))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_psi2_function_grads_match_jax(rng, dtype):
    """Gradients of sum(Psi2 * G) for (p, Z, mu, s) through the autograd
    Function (CPU tensors: the plain K1/K2 versions) against jax.grad of the
    JAX package's psi statistics, at a shape that cuts T into several ranges
    and M into a ragged tile."""
    T, M, Q = 70, 37, 4
    mu, s, Z, jp, tp = _inputs(rng, T, M, Q, log_ls_shift=0.4)
    G = rng.standard_normal((M, M))
    assert psi2.t_split(T, M)[0] > 1 and psi2.bwd_split(T, M)[0] > 1
    ref = _jax_psi2_grads(jp, Z, mu, s, jnp.asarray(G))
    leaves = {k: v.to(dtype).requires_grad_() for k, v in tp.items()}
    Zt, mut, st = (torch.tensor(x, dtype=dtype, requires_grad=True) for x in (Z, mu, s))
    if dtype == torch.float64:  # the Function in float64 (the plain versions take any dtype)
        out = psi2.RBFPsi2Sum.apply(*psi2.rbf_psi2_precompute(leaves, Zt, mut, st), Zt)
        tol = dict(rtol=1e-9, atol=0)
    else:  # the production entry: kernels' arithmetic in float32
        out = psi2.rbf_psi2_sum(leaves, Zt, mut, st)
        tol = dict(rtol=3e-4, atol=0)
    assert out.dtype == dtype
    (out * torch.tensor(G, dtype=dtype)).sum().backward()
    ours = [leaves["log_ls"].grad, leaves["log_var"].grad, Zt.grad, mut.grad, st.grad]
    refs = [ref[0]["log_ls"], ref[0]["log_var"], ref[1], ref[2], ref[3]]
    for a, b in zip(ours, refs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.double().numpy(), b, atol=tol["rtol"] * np.abs(b).max(), rtol=tol["rtol"])


def test_psi2_function_gradcheck(rng):
    T, M, Q = 11, 5, 2
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    args = [x.detach().clone().requires_grad_() for x in (*pre, torch.tensor(Z))]
    assert torch.autograd.gradcheck(psi2.RBFPsi2Sum.apply, args, eps=1e-6, atol=1e-7)


def test_psi2_function_takes_a_strided_cotangent(rng):
    """Autograd may hand the backward an expanded cotangent (here the one of
    ``out.sum()``); the backward must read it as a dense matrix."""
    mu, s, Z, _, tp = _inputs(rng, 20, 6, 2)
    Zt = torch.tensor(Z, requires_grad=True)
    psi2.rbf_psi2_sum(tp, Zt, torch.tensor(mu), torch.tensor(s)).sum().backward()
    Z2 = torch.tensor(Z, requires_grad=True)
    out = psi2.rbf_psi2_sum(tp, Z2, torch.tensor(mu), torch.tensor(s))
    torch.autograd.backward(out, torch.ones(6, 6, dtype=out.dtype))
    np.testing.assert_array_equal(Zt.grad.numpy(), Z2.grad.numpy())


@pytest.mark.parametrize("T,M", [(1, 1), (7, 100), (512, 100), (65, 130), (2048, 256), (100000, 3)])
def test_bwd_split_covers_t_in_whole_stages(T, M):
    n_split, t_per = psi2.bwd_split(T, M)
    assert n_split >= 1 and t_per % 8 == 0
    assert (n_split - 1) * t_per < T <= n_split * t_per


@pytest.mark.parametrize("T,M", [(1, 1), (7, 100), (512, 100), (513, 16), (2048, 256), (100000, 3)])
def test_t_split_covers_t_exactly(T, M):
    n_split, t_per = psi2.t_split(T, M)
    assert n_split >= 1 and t_per >= 1
    assert (n_split - 1) * t_per < T <= n_split * t_per


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "q", "gs_shape", "gs_contiguous"])
def test_kernel_argument_checks(rng, bad):
    T, M, Q = 9, 5, 3
    args = [torch.zeros(T), torch.zeros(T, M), torch.zeros(M, M), torch.zeros(T, Q), torch.zeros(M, Q)]
    Gs = torch.zeros(M, M)
    psi2._check(*args, Gs)
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = torch.zeros(T, M + 1)
    elif bad == "contiguous":
        args[2] = torch.zeros(M, 2 * M)[:, ::2]
    elif bad == "q":
        args[3], args[4] = torch.zeros(T, psi2.MAX_Q + 1), torch.zeros(M, psi2.MAX_Q + 1)
    elif bad == "gs_shape":
        Gs = torch.zeros(M, M + 1)
    else:
        Gs = torch.zeros(M, 2 * M)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        psi2._check(*args, Gs)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    T, M, Q = 65, 130, 5
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    dev = torch.device("cuda")
    pre = psi2.rbf_psi2_precompute({k: v.to(dev) for k, v in tp.items()}, torch.tensor(Z, device=dev),
                                   torch.tensor(mu, device=dev), torch.tensor(s, device=dev))
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z, device=dev))]
    n0 = psi2.launches
    k = psi2.psi2_time_sum(*args32)
    torch.cuda.synchronize()
    assert psi2.launches == n0 + 1
    ref = psi2.psi2_time_sum_plain(*[x.double() for x in args32])
    np.testing.assert_allclose(k.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4,
                               atol=2e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    T, M, Q = 65, 130, 5
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    dev = torch.device("cuda")
    pre = psi2.rbf_psi2_precompute({k: v.to(dev) for k, v in tp.items()}, torch.tensor(Z, device=dev),
                                   torch.tensor(mu, device=dev), torch.tensor(s, device=dev))
    G = rng.standard_normal((M, M))
    args32 = [x.to(torch.float32).contiguous()
              for x in (*pre, torch.tensor(Z, device=dev), torch.tensor(G + G.T, device=dev))]
    n0 = psi2.bwd_launches
    k = psi2.psi2_time_sum_bwd(*args32)
    torch.cuda.synchronize()
    assert psi2.bwd_launches == n0 + 1
    ref = psi2.psi2_time_sum_bwd_plain(*[x.double() for x in args32])
    for a, b in zip(k, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=3e-4,
                                   atol=3e-5 * float(b.abs().max()))
