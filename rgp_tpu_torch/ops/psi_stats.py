"""Psi-statistics: kernel expectations under Gaussian inputs (port of
``rgp_tpu/ops/psi_stats.py``).

  Psi0[t]    = E_q [ k(x_t, x_t) ]
  Psi1[t,m]  = E_q [ k(x_t, z_m) ]
  Psi2[m,m'] = sum_t E_q [ k(x_t, z_m) k(x_t, z_m') ]

for q(x_t) = N(mu_t, diag(s_t)). Closed forms exist for RBF, Linear, Bias,
White, their Sums (with the cross terms between parts) and Prods over
disjoint active dims (:func:`has_closed_psi`). Every other kernel is usable on
certain inputs (``s=None``): Psi1 = K(mu, Z), Psi2 = K^T K.

Dispatch of the RBF Psi2 time sum on uncertain inputs, an RBF part of a Sum
included: a float32 CUDA tensor goes to the hand-written kernels
(:mod:`rgp_tpu_torch.ops.cuda.psi2`): K1 for the value and, when gradients
are taken, K2 for the backward. A CPU tensor, or a float64 CUDA tensor, goes
to the plain chunked torch path, which recomputes each chunk in the backward
(the kernels take float32 only, as the JAX package's Pallas route did).
``prefer="scan"`` sends every RBF Psi2 time sum to the plain chunked path
whatever the device (the JAX package's ``prefer="scan"``): the route of a
Hessian, which cannot pass through K2. The plain path counts its calls in
``plain_psi2_calls`` so a run can show which route it took.

``remat=False`` turns the per-chunk recomputation off. A caller that runs the
statistics under ``torch.func.vmap`` (the batched sampler potential) passes
it: ``torch.utils.checkpoint`` cannot run on batched tensors, and autograd
then keeps every chunk's intermediates, the memory the chunking would save.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import RBF, Bias, Kernel, Linear, Prod, Sum, White, kern_slice
from ..linalg import hdot
from ..params import positive
from ..utils.profiling import annotate
from .cuda.psi2 import rbf_psi2_sum
from .cuda.psi2_contract import rbf_psi2_contract

__all__ = ["PsiStats", "psi_statistics", "psi01", "psi2_per_t", "psi2_contracted", "has_closed_psi"]

plain_psi2_calls = 0  # uncertain-input RBF Psi2 sums that took the plain path


class PsiStats(NamedTuple):
    psi0: torch.Tensor  # (T,)
    psi1: torch.Tensor  # (T, M)
    psi2: torch.Tensor  # (M, M) summed over t


# --------------------------------------------------------------------------- RBF


def _rbf_psi0(p, mu):
    return positive(p["log_var"]).expand(mu.shape[:-1])


def _rbf_psi1(p, Z, mu, s):
    """log Psi1 = log var - 1/2 sum_q log(1+s/l^2) - 1/2 (mu-z)^2/(l^2+s)."""
    var = positive(p["log_var"])
    ls = positive(p["log_ls"])
    l2 = ls * ls
    w = 1.0 / (l2 + s)  # (T, Q)
    logdet = -0.5 * torch.log1p(s / l2).sum(-1)  # (T,)
    mu2w = (w * mu * mu).sum(-1)  # (T,)
    A = hdot(w * mu, Z.T)  # (T, M)
    B = hdot(w, (Z * Z).T)  # (T, M)
    quad = mu2w[..., None] - 2.0 * A + B
    return var * torch.exp(logdet[..., None] - 0.5 * quad)


def _rbf_log_psi2_per_t(p, Z, mu, s):
    var = positive(p["log_var"])
    ls = positive(p["log_ls"])
    l2 = ls * ls
    w = 1.0 / (l2 + 2.0 * s)  # (T, Q)
    logconst = 2.0 * torch.log(var) - 0.5 * torch.log1p(2.0 * s / l2).sum(-1)
    Zs = Z / (2.0 * ls)
    zz = (Zs * Zs).sum(-1)
    D1 = zz[:, None] + zz[None, :] - 2.0 * hdot(Zs, Zs.T)  # (M, M)
    mu2w = (w * mu * mu).sum(-1)  # (T,)
    E = hdot(w * mu, Z.T) - 0.25 * hdot(w, (Z * Z).T)  # (T, M)
    C = torch.einsum("tq,mq,nq->tmn", w, Z, Z)  # (T, M, M)
    return (
        (logconst - mu2w)[:, None, None]
        - D1[None, :, :]
        + E[:, :, None]
        + E[:, None, :]
        - 0.5 * C
    )


def _rbf_psi2_chunk(p, Z, mu, s):
    """Sum_t Psi2_t over a chunk of timesteps; materializes (chunk, M, M)."""
    return torch.exp(_rbf_log_psi2_per_t(p, Z, mu, s)).sum(0)


def _rbf_psi2_per_t(p, Z, mu, s):
    """Per-timestep Psi2_t, (T, M, M): small-T use only (prediction)."""
    return torch.exp(_rbf_log_psi2_per_t(p, Z, mu, s))


def _chunked_sum(chunk_fn, mu, s, block, remat=True):
    """sum over chunks of ``block`` timesteps of ``chunk_fn(mu_c, s_c)``, an
    (M, M) partial sum; ``block=None`` takes all T at once.

    With grad on and ``remat``, each chunk is recomputed in the backward
    (``torch.utils.checkpoint``): otherwise autograd keeps every chunk's
    (block, M, M) intermediate, i.e. the whole dense tensor the chunking is
    there to avoid. ``remat=False`` is for callers under ``torch.func.vmap``
    (see the module note)."""
    T = mu.shape[0]
    if block is None or T <= block:
        return chunk_fn(mu, s)
    out = None
    for start in range(0, T, block):
        mu_c, s_c = mu[start:start + block], s[start:start + block]
        if remat and torch.is_grad_enabled():
            part = checkpoint(chunk_fn, mu_c, s_c, use_reentrant=False)
        else:
            part = chunk_fn(mu_c, s_c)
        out = part if out is None else out + part
    return out


def _rbf_psi2_sum_chunked(p, Z, mu, s, block, remat=True):
    """Plain Psi2 time sum over chunks of ``block`` timesteps (counterpart of
    the JAX package's ``_rbf_psi2_sum_xla``); ``block=None`` materializes."""
    return _chunked_sum(lambda mu_c, s_c: _rbf_psi2_chunk(p, Z, mu_c, s_c), mu, s, block, remat)


def _rbf_psi2_sum(p, Z, mu, s, block, prefer="auto", remat=True):
    global plain_psi2_calls
    if prefer not in ("auto", "scan"):
        raise ValueError(f"prefer must be 'auto' or 'scan', got {prefer!r}")
    if prefer == "auto" and mu.is_cuda and mu.dtype == torch.float32:
        return rbf_psi2_sum(p, Z, mu, s)
    plain_psi2_calls += 1
    return _rbf_psi2_sum_chunked(p, Z, mu, s, block, remat)


# ------------------------------------------------------------------------ Linear


def _linear_psi0(p, mu, s):
    v = positive(p["log_var"])
    return (v * (mu * mu + s)).sum(-1)


def _linear_psi1(p, Z, mu):
    v = positive(p["log_var"])
    return hdot(mu * v, Z.T)


def _linear_psi2_sum(p, Z, mu, s):
    v = positive(p["log_var"])
    psi1 = hdot(mu * v, Z.T)  # (T, M)
    Zv = Z * v  # (M, Q)
    s_tot = s.sum(0) if s.ndim == 2 else s  # (Q,)
    return hdot(psi1.T, psi1) + hdot(Zv * s_tot, Zv.T)


def _linear_psi2_per_t(p, Z, mu, s):
    v = positive(p["log_var"])
    psi1 = hdot(mu * v, Z.T)  # (T, M)
    Zv = Z * v
    outer = psi1[:, :, None] * psi1[:, None, :]
    corr = torch.einsum("tq,mq,nq->tmn", s, Zv, Zv)
    return outer + corr


# ---------------------------------------------------------------------- dispatch


def _broadcast_s(mu, s):
    if s is None:
        return torch.zeros_like(mu)
    return torch.as_tensor(s, dtype=mu.dtype, device=mu.device).expand(mu.shape)


def has_closed_psi(kern: Kernel) -> bool:
    """True if closed-form uncertain-input psi statistics exist for ``kern``.

    Kernels without closed forms (Matern family, RatQuad, StdPeriodic, MLP,
    Prod over shared dims) are still usable on certain inputs (``s=None``):
    Psi1 = K(mu, Z), Psi2 = K^T K, which is all the sparse-GP and GP-NARX
    paths need."""
    if isinstance(kern, (RBF, Linear, Bias, White)):
        return True
    if isinstance(kern, Sum):
        return all(has_closed_psi(k) for k in kern.parts)
    if isinstance(kern, Prod):
        # disjoint active dims: q diagonal => expectations factorize per part
        return _prod_disjoint(kern) and all(has_closed_psi(k) for k in kern.parts)
    return False


def _active_dims(kern: Kernel):
    if kern.active_dims is not None:
        return np.asarray(kern.active_dims, np.int64)
    return np.arange(kern.input_dim, dtype=np.int64)


def _prod_disjoint(kern: Prod) -> bool:
    seen = set()
    for k in kern.parts:
        dims = set(_active_dims(k).tolist())
        if seen & dims:
            return False
        seen |= dims
    return True


def _constant(var, shape, like):
    """``var`` (a 0-d tensor) broadcast to ``shape``, in ``like``'s dtype."""
    return var.to(like.dtype).expand(shape)


def psi01(kern: Kernel, p, Z, mu, s):
    """(Psi0 (T,), Psi1 (T, M)) only, for prediction paths that pair this
    with :func:`psi2_per_t` and must not pay for the summed Psi2."""
    if s is None and not has_closed_psi(kern):
        return kern.Kdiag(p, mu), kern.K(p, mu, Z)
    return _psi01(kern, p, Z, mu, _broadcast_s(mu, s))


def psi2_per_t(kern: Kernel, p, Z, mu, s):
    """Per-timestep Psi2_t (T, M, M), for prediction on small batches."""
    if s is None and not has_closed_psi(kern):
        K = kern.K(p, mu, Z)
        return K[:, :, None] * K[:, None, :]
    s = _broadcast_s(mu, s)
    T, M = mu.shape[0], Z.shape[0]
    if isinstance(kern, RBF):
        return _rbf_psi2_per_t(p, kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s))
    if isinstance(kern, Linear):
        return _linear_psi2_per_t(p, kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s))
    if isinstance(kern, Bias):
        var = positive(p["log_var"])
        return _constant(var * var, (T, M, M), mu)
    if isinstance(kern, White):
        return mu.new_zeros((T, M, M))
    if isinstance(kern, Sum):
        total = sum(psi2_per_t(k, pk, Z, mu, s) for k, pk in zip(kern.parts, p))
        return total + _sum_psi2_cross(kern, p, Z, mu, s, per_t=True)
    if isinstance(kern, Prod) and _prod_disjoint(kern):
        out = None
        for k, pk in zip(kern.parts, p):
            part = psi2_per_t(k, pk, Z, mu, s)
            out = part if out is None else out * part
        return out
    raise NotImplementedError(f"psi2 for kernel {type(kern).__name__}")


def psi2_contracted(p, Z, mu, s, alpha, W):
    """sum_{m,n} (alpha_d alpha_d^T - W)[m,n] Psi2_t[m,n] (T, D) of an RBF
    kernel without active dims, at float32 uncertain inputs on the card, by
    K3 (:mod:`rgp_tpu_torch.ops.cuda.psi2_contract`): the per-step Psi2 of
    :func:`psi2_per_t` contracted as it is computed, never formed."""
    return rbf_psi2_contract(p, Z, mu, _broadcast_s(mu, s), alpha, W)


def _psi01(kern: Kernel, p, Z, mu, s):
    T, M = mu.shape[0], Z.shape[0]
    if isinstance(kern, RBF):
        Za, mua, sa = kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s)
        return _rbf_psi0(p, mua), _rbf_psi1(p, Za, mua, sa)
    if isinstance(kern, Linear):
        Za, mua, sa = kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s)
        return _linear_psi0(p, mua, sa), _linear_psi1(p, Za, mua)
    if isinstance(kern, Bias):
        var = positive(p["log_var"])
        return var.expand((T,)), _constant(var, (T, M), mu)
    if isinstance(kern, White):
        # white noise contributes to the diagonal expectation only
        var = positive(p["log_var"])
        return var.expand((T,)), mu.new_zeros((T, M))
    if isinstance(kern, Sum) or (isinstance(kern, Prod) and _prod_disjoint(kern)):
        # a disjoint Prod factorizes over parts: q(x) is diagonal
        combine = (lambda a, b: a + b) if isinstance(kern, Sum) else (lambda a, b: a * b)
        out0, out1 = None, None
        for k, pk in zip(kern.parts, p):
            p0, p1 = _psi01(k, pk, Z, mu, s)
            out0 = p0 if out0 is None else combine(out0, p0)
            out1 = p1 if out1 is None else combine(out1, p1)
        return out0, out1
    raise NotImplementedError(f"psi stats for kernel {type(kern).__name__}")


# ------------------------------------------------------- additive cross terms


def _scatter_full(vals, dims, Q):
    """Per-active-dim values placed into a full-width (Q,) vector, zeros
    elsewhere."""
    idx = torch.as_tensor(dims, device=vals.device)
    return vals.new_zeros((Q,)).index_put((idx,), vals.expand((len(dims),)))


def _rbf_inv_l2_full(kern: RBF, p, Q):
    """Full-width inverse squared lengthscales: 1/l_q^2 on active dims, 0 off."""
    ls = positive(p["log_ls"])
    return _scatter_full(1.0 / (ls * ls), _active_dims(kern), Q)


def _linear_var_full(kern: Linear, p, Q):
    return _scatter_full(positive(p["log_var"]), _active_dims(kern), Q)


def _rbf_linear_cross(ka: RBF, pa, kb: Linear, pb, Z, mu, s, per_t: bool):
    """E_q[k_rbf(x, z_m) k_lin(x, z_n)], one direction, not symmetrized.

    Conditioning x on the RBF factor centred at z_m gives E[x_q g(x)] =
    Psi1_rbf[t,m] mtilde_q with mtilde_q = mu_q - s_q w_q (mu_q - z_mq), w_q =
    1/(l_q^2+s_q) on the RBF's active dims (0 elsewhere), so
    cross[t,m,n] = Psi1_rbf[t,m] sum_q v_q z_nq mtilde_q."""
    Q = mu.shape[-1]
    ia = _rbf_inv_l2_full(ka, pa, Q)  # (Q,)
    w = ia / (1.0 + s * ia)  # (T, Q): 1/(l^2+s) on A, 0 elsewhere
    vbZ = Z * _linear_var_full(kb, pb, Q)  # (M, Q)
    psi1a = _rbf_psi1(pa, kern_slice(ka, Z), kern_slice(ka, mu), kern_slice(ka, s))
    sw = s * w  # (T, Q)
    T1 = hdot(mu, vbZ.T)  # (T, M): sum_q v z_n mu
    T2 = hdot(sw * mu, vbZ.T)  # (T, M)
    if per_t:
        T3 = torch.einsum("tq,mq,nq->tmn", sw, Z, vbZ)
        return psi1a[:, :, None] * ((T1 - T2)[:, None, :] + T3)
    H = hdot(psi1a.T, sw)  # (M, Q)
    return hdot(psi1a.T, T1 - T2) + hdot(Z * H, vbZ.T)


def _linear_linear_cross(ka: Linear, pa, kb: Linear, pb, Z, mu, s, per_t: bool):
    """E_q[k_lina(x,z_m) k_linb(x,z_n)] = (va.z_m . mu)(vb.z_n . mu)
    + sum_q va_q vb_q z_mq z_nq s_q (one direction)."""
    Q = mu.shape[-1]
    vaZ = Z * _linear_var_full(ka, pa, Q)
    vbZ = Z * _linear_var_full(kb, pb, Q)
    A1 = hdot(mu, vaZ.T)  # (T, M)
    B1 = hdot(mu, vbZ.T)  # (T, M)
    if per_t:
        corr = torch.einsum("tq,mq,nq->tmn", s, vaZ, vbZ)
        return A1[:, :, None] * B1[:, None, :] + corr
    return hdot(A1.T, B1) + hdot(vaZ * s.sum(0), vbZ.T)


def _rbf_rbf_cross(ka: RBF, pa, kb: RBF, pb, Z, mu, s, per_t: bool):
    """E_q[k_a(x,z_m) k_b(x,z_n)] for two RBF parts with different
    hyperparameters or active dims (one direction). Per dim,
      ia (x-zm)^2 + ib (x-zn)^2 = g (x-c)^2 + (ia ib/g)(zm-zn)^2,
      g = ia+ib, c = (ia zm + ib zn)/g,
    and the Gaussian expectation is prod_q (1+s g)^{-1/2} exp(-h (mu-c)^2 / 2)
    with h = g/(1+s g); (mu-c)^2 is expanded so every term is a matmul or a
    tmn-einsum."""
    Q = mu.shape[-1]
    ia = _rbf_inv_l2_full(ka, pa, Q)
    ib = _rbf_inv_l2_full(kb, pb, Q)
    va = positive(pa["log_var"])
    vb = positive(pb["log_var"])
    g = ia + ib  # (Q,)
    safe_g = torch.where(g > 0, g, torch.ones_like(g))
    h = g / (1.0 + s * g)  # (T, Q)
    # constant (m,n) term: sum_q (ia ib / g) (zm - zn)^2
    r = ia * ib / safe_g  # (Q,)
    Zr = Z * torch.sqrt(r)
    zz = (Zr * Zr).sum(-1)
    D = zz[:, None] + zz[None, :] - 2.0 * hdot(Zr, Zr.T)  # (M, M)
    logdet = -0.5 * torch.log1p(s * g).sum(-1)  # (T,)
    E0 = (h * mu * mu).sum(-1)
    # -2 mu c and c^2 terms split over (t,m) / (t,n) / (t,m,n)
    wa = ia / safe_g  # fraction of c from z_m
    wb = ib / safe_g
    Am = -2.0 * hdot(h * mu, (Z * wa).T) + hdot(h, ((Z * wa) ** 2).T)  # (T, M)
    An = -2.0 * hdot(h * mu, (Z * wb).T) + hdot(h, ((Z * wb) ** 2).T)  # (T, M)
    Cmn = 2.0 * torch.einsum("tq,mq,nq->tmn", h, Z * wa, Z * wb)
    log_cross = (
        torch.log(va * vb)
        + (logdet - 0.5 * E0)[:, None, None]
        - 0.5 * (Am[:, :, None] + An[:, None, :] + Cmn)
        - 0.5 * D[None, :, :]
    )
    cross = torch.exp(log_cross)
    return cross if per_t else cross.sum(0)


def _pair_cross_psi2(ki, pi, kj, pj, Z, mu, s, per_t: bool):
    """Symmetrized cross term of the (i,j) pair:
    E[k_i(x,zm)k_j(x,zn)] + E[k_j(x,zm)k_i(x,zn)] = C + C^T."""
    if isinstance(ki, RBF) and isinstance(kj, Linear):
        C = _rbf_linear_cross(ki, pi, kj, pj, Z, mu, s, per_t)
    elif isinstance(ki, Linear) and isinstance(kj, RBF):
        C = _rbf_linear_cross(kj, pj, ki, pi, Z, mu, s, per_t)
    elif isinstance(ki, Linear) and isinstance(kj, Linear):
        C = _linear_linear_cross(ki, pi, kj, pj, Z, mu, s, per_t)
    elif isinstance(ki, RBF) and isinstance(kj, RBF):
        C = _rbf_rbf_cross(ki, pi, kj, pj, Z, mu, s, per_t)
    else:
        raise NotImplementedError(
            f"psi2 cross term between {type(ki).__name__} and {type(kj).__name__}"
        )
    return C + C.mT


def _sum_psi2_cross(kern: Sum, p, Z, mu, s, per_t: bool = False):
    """Cross terms E[k_a(x,zm) k_b(x,zm')] of an additive kernel: closed forms
    for every pair among {RBF, Linear, Bias}; White crosses vanish. Each
    pair's term is profiled as the region ``psi.cross``."""
    T, M = mu.shape[0], Z.shape[0]
    total = mu.new_zeros((T, M, M) if per_t else (M, M))
    n = len(kern.parts)
    for i in range(n):
        for j in range(i + 1, n):
            ki, kj = kern.parts[i], kern.parts[j]
            pi, pj = p[i], p[j]
            if isinstance(ki, White) or isinstance(kj, White):
                continue
            with annotate("psi.cross"):
                if isinstance(ki, Bias) or isinstance(kj, Bias):
                    if isinstance(ki, Bias):
                        bvar, other, po = positive(pi["log_var"]), kj, pj
                    else:
                        bvar, other, po = positive(pj["log_var"]), ki, pi
                    _, psi1_o = _psi01(other, po, Z, mu, s)  # (T, M)
                    if per_t:
                        cross = bvar * (psi1_o[:, :, None] + psi1_o[:, None, :])
                    else:
                        colsum = psi1_o.sum(0)  # (M,)
                        cross = bvar * (colsum[:, None] + colsum[None, :])
                    total = total + cross
                else:
                    total = total + _pair_cross_psi2(ki, pi, kj, pj, Z, mu, s, per_t)
    return total


# ------------------------------------------------------------------ the sums


def psi_statistics(kern: Kernel, p, Z, mu, s=None, *, block: Optional[int] = 128, prefer: str = "auto",
                   remat: bool = True) -> PsiStats:
    """(Psi0, Psi1, sum_t Psi2) for q(x_t) = N(mu_t, diag(s_t)).

    ``s=None`` means certain inputs: Psi1 = K(mu, Z), Psi2 = K^T K, Psi0 =
    Kdiag, for any kernel. ``block`` chunks the plain Psi2 time sums
    (``None`` materializes (T, M, M)); the CUDA kernels ignore it.
    ``prefer``: ``"auto"`` (float32 CUDA to K1/K2) or ``"scan"`` (the plain
    chunked path on every device, honouring ``block``). ``remat``: recompute
    each plain chunk in the backward; pass False under ``torch.func.vmap``
    (see the module note). Kernels without closed-form psi statistics
    (:func:`has_closed_psi`) take certain inputs only. Profiled as the
    region ``psi.stats``."""
    with annotate("psi.stats"):
        if s is None:
            K = kern.K(p, mu, Z)
            return PsiStats(kern.Kdiag(p, mu), K, hdot(K.T, K))
        s = _broadcast_s(mu, s)
        psi0, psi1 = _psi01(kern, p, Z, mu, s)
        return PsiStats(psi0, psi1, _psi2_sum(kern, p, Z, mu, s, block, prefer, remat))


def _psi2_sum(kern, p, Z, mu, s, block, prefer="auto", remat=True):
    M = Z.shape[0]
    if isinstance(kern, RBF):
        return _rbf_psi2_sum(p, kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s), block,
                             prefer, remat)
    if isinstance(kern, Linear):
        return _linear_psi2_sum(p, kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s))
    if isinstance(kern, Bias):
        var = positive(p["log_var"])
        return _constant(mu.shape[0] * var * var, (M, M), mu)
    if isinstance(kern, White):
        return mu.new_zeros((M, M))
    if isinstance(kern, Sum):
        total = None
        for k, pk in zip(kern.parts, p):
            part = _psi2_sum(k, pk, Z, mu, s, block, prefer, remat)
            total = part if total is None else total + part
        return total + _sum_psi2_cross(kern, p, Z, mu, s, per_t=False)
    if isinstance(kern, Prod) and _prod_disjoint(kern):
        return _chunked_per_t_sum(lambda mu_c, s_c: psi2_per_t(kern, p, Z, mu_c, s_c), mu, s, block, remat)
    raise NotImplementedError(f"psi2 for kernel {type(kern).__name__}")


def _chunked_per_t_sum(per_t_fn, mu, s, block, remat=True):
    """sum_t of a per-timestep (T, M, M) psi2, ``block`` timesteps at a time
    (the disjoint-Prod path)."""
    return _chunked_sum(lambda mu_c, s_c: per_t_fn(mu_c, s_c).sum(0), mu, s, block, remat)
