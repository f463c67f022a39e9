"""K1 (rgp_tpu_torch.ops.cuda.psi2) and the port's psi statistics against
rgp_tpu on the CPU.

Tolerances: the plain K1 version in float32 against the Pallas kernel in
interpret mode at the Pallas tests' tolerance (rtol 2e-4, atol 2e-5,
tests/test_pallas.py); in float64 the T-split reduce changes only the
summation order (rtol 1e-10); psi01 / psi2_per_t are the same closed forms
(rtol 1e-12). K2's plain version and the autograd Function's gradients: the
Pallas backward tests' 3e-4 in float32 (tests/test_pallas.py), 1e-9 in
float64, where only the summation order differs. The plain versions follow
the kernels' plans: K1's output is its mirrored upper triangle (exactly
symmetric), K2 takes the cotangent with any strides and gives the same bits
as for its dense copy. The CUDA kernels themselves are held against the
plain versions on the card by the tests marked ``cuda`` (one device launch a
call, bit-identical reruns) and by chip_smoke.py.

The batched forms (a leading batch axis, one launch) against ``jax.vmap`` of
the Pallas kernels in interpret mode, at the single kernels' tolerances,
with Z shared and batched; the Function under ``torch.func.vmap`` and under
a vmap of a vmap equal to its instances at rtol 1e-12 in float64, through
one batched call.
"""

import functools

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
    assert psi2.t_split(T, M, Q)[0] > 1  # the T-split reduce is exercised
    ours = psi2.psi2_time_sum_plain(*pre, torch.tensor(Z)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


@pytest.mark.parametrize("T,M,Q", [(40, 37, 3), (33, 50, 40)])
def test_plain_k1_symmetric_plan_matches_pallas_interpret(rng, T, M, Q):
    """A ragged M cuts the last diagonal tile (32-wide tiles at Q <= 32,
    16-wide above): the output is exactly symmetric and matches the Pallas
    kernel."""
    assert M % psi2.fwd_tile(Q) != 0
    mu, s, Z, _, tp = _inputs(rng, T, M, Q, log_ls_shift=0.5)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z))]
    ours = psi2.psi2_time_sum(*args32)
    assert torch.equal(ours, ours.T)
    ref = np.asarray(_psi2_pallas_raw(*[jnp.asarray(x.numpy()) for x in args32],
                                      bt=8, bm=64, interpret=True))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-5)


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
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z), torch.tensor(G))]
    out = psi2.psi2_time_sum(*args32[:5])
    assert psi2.bwd_split(T, M)[0] > 1  # the ordered reduce over T ranges is exercised
    dbase, dE, dD1, dw, dzc = psi2.psi2_time_sum_bwd(*args32, out)  # CPU tensors -> the plain version
    # the Pallas kernel takes the symmetrized cotangent; the port forms it
    ref = _psi2_bwd_raw(*[jnp.asarray(x.numpy()) for x in args32[:5]], jnp.asarray((G + G.T).astype(np.float32)),
                        bt=8, bm=64, interpret=True)
    for a, b in zip((dbase, dE, dw, dzc), ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4, atol=3e-4)
    # K1 reads D1's upper triangle only: dD1 is -out * Gs there, -out * g on the diagonal
    G32 = G.astype(np.float32)
    want = np.triu(-(out.numpy() * (G32 + G32.T)), 1) + np.diag(-(np.diag(out.numpy()) * np.diag(G32)))
    np.testing.assert_array_equal(dD1.numpy(), want)


@pytest.mark.parametrize("layout", ["transposed", "expanded"])
def test_plain_k2_reads_a_strided_cotangent(rng, layout):
    """A transposed or an expanded cotangent gives the same gradients as its
    dense copy, bit for bit."""
    T, M, Q = 30, 37, 3
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    args = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z))]
    out = psi2.psi2_time_sum(*args)
    G = torch.tensor(rng.standard_normal((M, M)), dtype=torch.float32)
    g = G.T if layout == "transposed" else G[:1, :1].expand(M, M)
    assert not g.is_contiguous()
    for a, b in zip(psi2.psi2_time_sum_bwd(*args, g, out), psi2.psi2_time_sum_bwd(*args, g.contiguous(), out)):
        assert torch.equal(a, b)


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
    assert psi2.t_split(T, M, Q)[0] > 1 and psi2.bwd_split(T, M)[0] > 1
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
    for Q in (1, 20, 24, 32, 64, 128):  # the tile edge, so the block count, depends on Q
        n_split, t_per = psi2.t_split(T, M, Q)
        assert n_split >= 1 and t_per >= 1
        assert (n_split - 1) * t_per < T <= n_split * t_per
        n = -(-M // psi2.fwd_tile(Q))
        assert n * (n + 1) // 2 * n_split <= max(n * (n + 1) // 2, 4 * 132 * 2)  # at most 4 waves


@pytest.mark.parametrize("k", [0, 1, 3])
def test_order_spread_orders_keep_the_sums(rng, monkeypatch, k):
    """rgp_tpu_torch.bench.order_spread's order k: T ranges k + 1 times as
    long still cover T exactly (K2's in whole 8-step stages), and K1 and K2
    under them still match the Pallas kernels in interpret mode."""
    from rgp_tpu_torch.bench.order_spread import longer_ranges

    for T, M in ((1, 1), (40, 24), (502, 100), (2048, 256)):
        n, t_per = longer_ranges(psi2.t_split, k)(T, M, 20)
        assert (n - 1) * t_per < T <= n * t_per
        n, t_per = longer_ranges(psi2.bwd_split, k)(T, M)
        assert (n - 1) * t_per < T <= n * t_per and t_per % 8 == 0
    T, M, Q = 70, 24, 3
    planned = psi2.t_split(T, M, Q)[1], psi2.bwd_split(T, M)[1]
    monkeypatch.setattr(psi2, "t_split", longer_ranges(psi2.t_split, k))
    monkeypatch.setattr(psi2, "bwd_split", longer_ranges(psi2.bwd_split, k))
    assert (psi2.t_split(T, M, Q)[1], psi2.bwd_split(T, M)[1]) == ((k + 1) * planned[0], (k + 1) * planned[1])
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s))
    G = rng.standard_normal((M, M))
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z))]
    jargs = [jnp.asarray(x.numpy()) for x in args32]
    out = psi2.psi2_time_sum(*args32)
    np.testing.assert_allclose(out.numpy(), np.asarray(_psi2_pallas_raw(*jargs, bt=8, bm=64, interpret=True)),
                               rtol=2e-4, atol=2e-5)
    grads = psi2.psi2_time_sum_bwd(*args32, torch.tensor(G, dtype=torch.float32), out)
    ref = _psi2_bwd_raw(*jargs, jnp.asarray((G + G.T).astype(np.float32)), bt=8, bm=64, interpret=True)
    for a, b in zip((grads[0], grads[1], grads[3], grads[4]), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4, atol=3e-4)


# "gs_shape": the cotangent's shape (K2 now takes g and forms Gs itself; a
# non-contiguous g is read through its strides, so it is no longer refused)
@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "q", "gs_shape", "g_dtype", "out_shape",
                                 "out_contiguous"])
def test_kernel_argument_checks(rng, bad):
    T, M, Q = 9, 5, 3
    args = [torch.zeros(T), torch.zeros(T, M), torch.zeros(M, M), torch.zeros(T, Q), torch.zeros(M, Q)]
    g, out = torch.zeros(M, M), torch.zeros(M, M)
    psi2._check(*args, g, out)
    psi2._check(*args, g.T, out)  # g is read through its strides
    psi2._check(*args, torch.zeros(1, 1).expand(M, M), out)
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = torch.zeros(T, M + 1)
    elif bad == "contiguous":
        args[2] = torch.zeros(M, 2 * M)[:, ::2]
    elif bad == "q":
        args[3], args[4] = torch.zeros(T, psi2.MAX_Q + 1), torch.zeros(M, psi2.MAX_Q + 1)
    elif bad == "gs_shape":
        g = torch.zeros(M, M + 1)
    elif bad == "g_dtype":
        g = g.double()
    elif bad == "out_shape":
        out = torch.zeros(M + 1, M)
    else:
        out = torch.zeros(M, 2 * M)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        psi2._check(*args, g, out)


def _batched_inputs(rng, B, T, M, Q, shared_z, device="cpu"):
    """B instances' float32 (base, E, D1, w, Z) on ``device``: one
    lengthscale shift each, and Z shared (expanded, batch stride 0) or each
    instance's own."""
    Z = rng.standard_normal((M, Q))
    cols = []
    for b in range(B):
        mu, s, Zb, _, tp = _inputs(rng, T, M, Q, log_ls_shift=0.1 * b)
        Zb = Z if shared_z else Zb
        pre = psi2.rbf_psi2_precompute(tp, torch.tensor(Zb), torch.tensor(mu), torch.tensor(s))
        cols.append([x.to(torch.float32) for x in (*pre, torch.tensor(Zb))])
    args = [torch.stack(xs).to(device) for xs in zip(*cols)]
    if shared_z:
        args[4] = args[4][0].expand(B, M, Q)
    return args


@pytest.mark.parametrize("shared_z", [True, False])
def test_plain_batched_k1_k2_match_jax_vmap_interpret(rng, shared_z):
    """The batched plain K1 and K2 against ``jax.vmap`` of the Pallas kernels
    (one pallas_call with the batch as a leading grid axis) in interpret
    mode, at the single kernels' tolerances; each instance's bits are the
    single plain version's."""
    B, T, M, Q = 3, 40, 24, 3
    args = _batched_inputs(rng, B, T, M, Q, shared_z)
    G = torch.tensor(rng.standard_normal((B, M, M)), dtype=torch.float32)
    out = psi2.psi2_time_sum_batched(*args)  # CPU tensors -> the plain versions
    grads = psi2.psi2_time_sum_bwd_batched(*args, G, out)
    jargs = [jnp.asarray(x.numpy()) for x in args[:4]] + [jnp.asarray(args[4][0].numpy() if shared_z
                                                                       else args[4].numpy())]
    axes = (0, 0, 0, 0, None if shared_z else 0)
    fwd = jax.vmap(functools.partial(_psi2_pallas_raw, bt=8, bm=64, interpret=True), in_axes=axes)
    bwd = jax.vmap(functools.partial(_psi2_bwd_raw, bt=8, bm=64, interpret=True), in_axes=axes + (0,))
    np.testing.assert_allclose(out.numpy(), np.asarray(fwd(*jargs)), rtol=2e-4, atol=2e-5)
    ref = bwd(*jargs, jnp.asarray((G + G.transpose(1, 2)).numpy()))
    for a, b in zip((grads[0], grads[1], grads[3], grads[4]), ref):
        assert a.shape[0] == B
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4, atol=3e-4)
    for i in range(B):
        single = [x[i] for x in args]
        assert torch.equal(out[i], psi2.psi2_time_sum(*single))
        for a, b in zip(grads, psi2.psi2_time_sum_bwd(*single, G[i], out[i])):
            assert torch.equal(a[i], b)


def _f64_psi2_loss(tp, Z, mu, s, G):
    def loss(lv, ll):
        pre = psi2.rbf_psi2_precompute({"log_var": lv, "log_ls": ll}, Z, mu, s)
        return (psi2.RBFPsi2Sum.apply(*pre, Z) * G).sum()

    return loss


@pytest.mark.parametrize("depth", [1, 2])
def test_psi2_function_under_nested_vmap_equals_instances(rng, monkeypatch, depth):
    """``RBFPsi2Sum`` in float64 under ``torch.func.vmap`` (depth 1) and a
    vmap of a vmap (depth 2, the batched Function's own rule folding the
    outer axis into its batch): values and gradients of every instance equal
    the unbatched calls at rtol 1e-12, through one batched forward and one
    batched backward call."""
    T, M, Q = 30, 9, 3
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    loss = _f64_psi2_loss(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s),
                          torch.tensor(rng.standard_normal((M, M))))
    shape = (2, 3) if depth == 2 else (4,)
    ll = (tp["log_ls"] + 0.1 * torch.tensor(rng.standard_normal(shape + (1,)))).requires_grad_()
    lv = (tp["log_var"] + 0.1 * torch.tensor(rng.standard_normal(shape))).requires_grad_()
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("psi2_time_sum_batched", "fwd"), ("psi2_time_sum_bwd_batched", "bwd")):
        def counted(*a, _f=getattr(psi2, name), _k=key):
            calls[_k] += 1
            return _f(*a)

        monkeypatch.setattr(psi2, name, counted)
    f = loss
    for _ in range(depth):
        f = torch.func.vmap(f)
    vals = f(lv, ll)
    g_lv, g_ll = torch.autograd.grad(vals.sum(), (lv, ll))
    assert calls == {"fwd": 1, "bwd": 1}
    for idx in np.ndindex(*shape):
        a, b = lv[idx].detach().requires_grad_(), ll[idx].detach().requires_grad_()
        v = loss(a, b)
        ga, gb = torch.autograd.grad(v, (a, b))
        np.testing.assert_allclose(float(vals[idx].detach()), float(v.detach()), rtol=1e-12)
        np.testing.assert_allclose(float(g_lv[idx]), float(ga), rtol=1e-12)
        np.testing.assert_allclose(g_ll[idx].numpy(), gb.numpy(), rtol=1e-12)


def test_batched_kernel_argument_checks():
    B, T, M, Q = 4, 9, 5, 3
    args = [torch.zeros(B, T), torch.zeros(B, T, M), torch.zeros(B, M, M), torch.zeros(B, T, Q),
            torch.zeros(M, Q).expand(B, M, Q)]
    g, out = torch.zeros(1, 1, 1).expand(B, M, M), torch.zeros(B, M, M)
    psi2._check(*args, g, out, batch=B)  # a shared (stride-0) Z and an expanded cotangent are taken
    psi2._check(*args, g.transpose(1, 2), out, batch=B)
    for bad in ("batch", "trailing", "shape", "dtype"):
        a = list(args)
        if bad == "batch":
            a[0] = torch.zeros(B + 1, T)
        elif bad == "trailing":
            a[2] = torch.zeros(B, M, 2 * M)[:, :, ::2]
        elif bad == "shape":
            a[3] = torch.zeros(B, T, Q + 1)
        else:
            a[1] = a[1].double()
        with pytest.raises((TypeError, ValueError)):
            psi2._check(*a, g, out, batch=B)
    with pytest.raises(ValueError):
        psi2._check(*(x[:0] for x in args), batch=0)


@pytest.mark.parametrize("n,instance_bytes,want", [
    (8, 1 << 20, [(0, 8)]),
    (70000, 1, [(0, 65535), (65535, 70000)]),
    (10, 1 << 28, [(0, 4), (4, 8), (8, 10)]),
    (3, 1 << 31, [(0, 1), (1, 2), (2, 3)]),
])
def test_batch_chunks_respect_the_grid_and_workspace(n, instance_bytes, want):
    """A batch is one launch unless it passes the grid's z limit or the
    wrappers' 1 GiB of scratch; then it is cut into launches that cover it."""
    assert psi2._chunks(n, instance_bytes) == want


def _device_launches(fn):
    """Device kernels, copies and fills torch.profiler records in one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    return result, sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))


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
    psi2.psi2_time_sum(*args32)  # build, load and make the ticket counters outside the count
    n0 = psi2.launches
    k, n_device = _device_launches(lambda: psi2.psi2_time_sum(*args32))
    assert psi2.launches == n0 + 1 and n_device == 1
    assert torch.equal(k, psi2.psi2_time_sum(*args32)) and torch.equal(k, k.T)
    ref = psi2.psi2_time_sum_plain(*[x.double() for x in args32])
    np.testing.assert_allclose(k.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4,
                               atol=2e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,Q", [(65, 130, 5), (24, 1200, 20)])
def test_k2_kernel_matches_plain_on_card(rng, T, M, Q):
    """K2 against its plain version, at a shape whose columns are resident in
    shared memory and one it streams; a transposed cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    dev = torch.device("cuda")
    pre = psi2.rbf_psi2_precompute({k: v.to(dev) for k, v in tp.items()}, torch.tensor(Z, device=dev),
                                   torch.tensor(mu, device=dev), torch.tensor(s, device=dev))
    G = torch.tensor(rng.standard_normal((M, M)), dtype=torch.float32, device=dev)
    args32 = [x.to(torch.float32).contiguous() for x in (*pre, torch.tensor(Z, device=dev))]
    out = psi2.psi2_time_sum(*args32)
    psi2.psi2_time_sum_bwd(*args32, G.T, out)
    n0 = psi2.bwd_launches
    k, n_device = _device_launches(lambda: psi2.psi2_time_sum_bwd(*args32, G.T, out))
    assert psi2.bwd_launches == n0 + 1 and n_device == 1
    for a, b in zip(k, psi2.psi2_time_sum_bwd(*args32, G.T, out)):
        assert torch.equal(a, b)
    ref = psi2.psi2_time_sum_bwd_plain(*[x.double() for x in args32], G.T.double(), out.double())
    for a, b in zip(k, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=3e-4,
                                   atol=3e-5 * float(b.abs().max()))


def _vmapped_psi2_loss(tp, Z, mu, s, G, shifts, psi2_sum=psi2.rbf_psi2_sum):
    """sum(psi2_sum(...) * G) for one set of hyperparameters per shift of
    log_ls: under ``torch.func.vmap`` (values and gradients of every set at
    once) and per set in a loop."""
    C = len(shifts)
    log_ls = (tp["log_ls"][None] + torch.as_tensor(shifts, dtype=tp["log_ls"].dtype,
                                                   device=tp["log_ls"].device)[:, None]).requires_grad_()
    log_var = tp["log_var"].expand(C).clone().requires_grad_()

    def loss(lv, ll):
        return (psi2_sum({"log_var": lv, "log_ls": ll}, Z, mu, s) * G).sum()

    batched = torch.func.vmap(loss)(log_var, log_ls)
    grads = torch.autograd.grad(batched.sum(), (log_var, log_ls))
    rows = []
    for c in range(C):
        lv, ll = log_var[c].detach().requires_grad_(), log_ls[c].detach().requires_grad_()
        v = loss(lv, ll)
        rows.append((v, *torch.autograd.grad(v, (lv, ll))))
    return (batched, *grads), rows


def test_psi2_function_under_vmap_equals_instances(rng):
    """The Function's vmap rule (a chain axis of the sampler potential):
    values and gradients of every batch instance equal the unbatched calls
    (CPU tensors: the kernels' plain versions)."""
    T, M, Q = 30, 9, 3
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    G = torch.tensor(rng.standard_normal((M, M)))
    (vals, g_lv, g_ll), rows = _vmapped_psi2_loss(tp, torch.tensor(Z), torch.tensor(mu), torch.tensor(s), G,
                                                   [0.0, 0.2, -0.1])
    for c, (v, glv, gll) in enumerate(rows):
        np.testing.assert_allclose(float(vals[c]), float(v), rtol=1e-12)
        np.testing.assert_allclose(float(g_lv[c]), float(glv), rtol=1e-12)
        np.testing.assert_allclose(g_ll[c].numpy(), gll.numpy(), rtol=1e-12)


def test_psi2_function_is_differentiable_once(rng):
    """A second derivative through K1/K2 raises: ``torch.autograd.grad``
    would otherwise prune ``once_differentiable``'s error node and return a
    Hessian lacking every path through K2."""
    mu, s, Z, _, tp = _inputs(rng, 20, 6, 2)

    def f(log_ls):
        p = {"log_var": tp["log_var"], "log_ls": log_ls}
        return psi2.rbf_psi2_sum(p, torch.tensor(Z), torch.tensor(mu), torch.tensor(s)).pow(2).sum()

    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.functional.hessian(f, tp["log_ls"].clone())


@pytest.mark.cuda
def test_psi2_function_under_vmap_on_card(rng):
    """On the card the vmap rule launches K1 once for the batch and K2 once
    in the backward; values and gradients against the plain float64 path per
    instance, at K2's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    T, M, Q, C = 512, 100, 20, 4
    mu, s, Z, _, tp = _inputs(rng, T, M, Q)
    dev = torch.device("cuda")
    t32 = {k: v.to(dev, torch.float32) for k, v in tp.items()}
    G = torch.tensor(rng.standard_normal((M, M)), dtype=torch.float32, device=dev)
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (Z, mu, s)]
    shifts = [0.0, 0.2, -0.1, 0.3]
    psi2.rbf_psi2_sum(t32, *args)  # build and load outside the count
    n1, n2 = psi2.launches, psi2.bwd_launches
    (vals, g_lv, g_ll), _ = _vmapped_psi2_loss(t32, *args, G, shifts)
    assert (psi2.launches - n1, psi2.bwd_launches - n2) == (1 + C, 1 + C)  # the vmap, then the loop
    t64 = {k: v.to(dev) for k, v in tp.items()}

    def plain(p, Z_, mu_, s_):
        return psi_stats._rbf_psi2_sum_chunked(p, Z_, mu_, s_, None)

    _, rows = _vmapped_psi2_loss(t64, *[x.double() for x in args], G.double(), shifts, plain)
    for c, (v, glv, gll) in enumerate(rows):
        np.testing.assert_allclose(float(vals[c]), float(v), rtol=3e-4)
        np.testing.assert_allclose(float(g_lv[c]), float(glv), rtol=3e-4)
        np.testing.assert_allclose(g_ll[c].cpu().numpy(), gll.cpu().numpy(), rtol=3e-4,
                                   atol=3e-4 * float(gll.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shared_z", [True, False])
def test_batched_kernels_equal_single_launches_on_card(rng, shared_z):
    """Batched K1 and K2 on the card: one launch for the batch, and every
    instance's outputs the bits of its own single launch (an expanded
    cotangent for K2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, T, M, Q = 5, 65, 130, 5
    dev = torch.device("cuda")
    args = _batched_inputs(rng, B, T, M, Q, shared_z, dev)
    assert args[4].stride(0) == 0 if shared_z else args[4].is_contiguous()
    g = torch.tensor(rng.standard_normal((1, 1, 1)), dtype=torch.float32, device=dev).expand(B, M, M)
    psi2.psi2_time_sum(*[x[0] for x in args])  # build and load outside the count
    n1, n2 = psi2.launches, psi2.bwd_launches
    out = psi2.psi2_time_sum_batched(*args)
    grads = psi2.psi2_time_sum_bwd_batched(*args, g, out)
    assert (psi2.launches - n1, psi2.bwd_launches - n2) == (1, 1)
    for i in range(B):
        single = [x[i].contiguous() for x in args]
        assert torch.equal(out[i], psi2.psi2_time_sum(*single))
        for a, b in zip(grads, psi2.psi2_time_sum_bwd(*single, g[i], out[i])):
            assert torch.equal(a[i], b)
