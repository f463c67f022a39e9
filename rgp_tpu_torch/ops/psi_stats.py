"""Psi-statistics: kernel expectations under Gaussian inputs (port of
``rgp_tpu/ops/psi_stats.py``, RBF path).

  Psi0[t]    = E_q [ k(x_t, x_t) ]
  Psi1[t,m]  = E_q [ k(x_t, z_m) ]
  Psi2[m,m'] = sum_t E_q [ k(x_t, z_m) k(x_t, z_m') ]

for q(x_t) = N(mu_t, diag(s_t)). Certain inputs (``s=None``) give Psi1 = K(mu,
Z) and Psi2 = K^T K.

Dispatch of the RBF Psi2 time sum on uncertain inputs: a float32 CUDA tensor
goes to the hand-written kernels (:mod:`rgp_tpu_torch.ops.cuda.psi2`): K1 for
the value and, when gradients are taken, K2 for the backward. A CPU tensor, or
a float64 CUDA tensor, goes to the plain chunked torch path, which recomputes
each chunk in the backward (the kernels take float32 only, as the JAX
package's Pallas route did). The plain path counts its calls in
``plain_psi2_calls`` so a run can show which route it took.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import RBF, Kernel, kern_slice
from ..linalg import hdot
from ..params import positive
from .cuda.psi2 import rbf_psi2_sum

__all__ = ["PsiStats", "psi_statistics", "psi01", "psi2_per_t"]

plain_psi2_calls = 0  # uncertain-input RBF Psi2 sums that took the plain path


class PsiStats(NamedTuple):
    psi0: torch.Tensor  # (T,)
    psi1: torch.Tensor  # (T, M)
    psi2: torch.Tensor  # (M, M) summed over t


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


def _rbf_psi2_sum_chunked(p, Z, mu, s, block):
    """Plain Psi2 time sum over chunks of ``block`` timesteps (counterpart of
    the JAX package's ``_rbf_psi2_sum_xla``); ``block=None`` materializes.

    With grad on, each chunk is recomputed in the backward
    (``torch.utils.checkpoint``): otherwise autograd keeps every chunk's
    (block, M, M) intermediate, i.e. the whole dense tensor the chunking is
    there to avoid."""
    T = mu.shape[0]
    if block is None or T <= block:
        return _rbf_psi2_chunk(p, Z, mu, s)
    out = None
    for start in range(0, T, block):
        mu_c, s_c = mu[start:start + block], s[start:start + block]
        if torch.is_grad_enabled():
            part = checkpoint(_rbf_psi2_chunk, p, Z, mu_c, s_c, use_reentrant=False)
        else:
            part = _rbf_psi2_chunk(p, Z, mu_c, s_c)
        out = part if out is None else out + part
    return out


def _broadcast_s(mu, s):
    if s is None:
        return torch.zeros_like(mu)
    return torch.as_tensor(s, dtype=mu.dtype, device=mu.device).expand(mu.shape)


def _require_rbf(kern):
    if not isinstance(kern, RBF):
        raise NotImplementedError(
            f"psi statistics for kernel {type(kern).__name__} are not ported yet"
        )


def psi01(kern: Kernel, p, Z, mu, s):
    """(Psi0 (T,), Psi1 (T, M)) only, for prediction paths that pair this
    with :func:`psi2_per_t`."""
    _require_rbf(kern)
    s = _broadcast_s(mu, s)
    Za, mua, sa = kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s)
    return _rbf_psi0(p, mua), _rbf_psi1(p, Za, mua, sa)


def psi2_per_t(kern: Kernel, p, Z, mu, s):
    """Per-timestep Psi2_t (T, M, M), for prediction on small batches."""
    _require_rbf(kern)
    s = _broadcast_s(mu, s)
    return _rbf_psi2_per_t(p, kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s))


def psi_statistics(kern: Kernel, p, Z, mu, s=None, *, block: Optional[int] = 128) -> PsiStats:
    """(Psi0, Psi1, sum_t Psi2) for q(x_t) = N(mu_t, diag(s_t)).

    ``s=None`` means certain inputs: Psi1 = K(mu, Z), Psi2 = K^T K, Psi0 =
    Kdiag, for any kernel. ``block`` chunks the plain Psi2 time sum (``None``
    materializes (T, M, M)); the CUDA kernel ignores it."""
    if s is None:
        K = kern.K(p, mu, Z)
        return PsiStats(kern.Kdiag(p, mu), K, hdot(K.T, K))
    psi0, psi1 = psi01(kern, p, Z, mu, s)
    s = _broadcast_s(mu, s)
    Za, mua, sa = kern_slice(kern, Z), kern_slice(kern, mu), kern_slice(kern, s)
    return PsiStats(psi0, psi1, _rbf_psi2_sum(p, Za, mua, sa, block))


def _rbf_psi2_sum(p, Z, mu, s, block):
    global plain_psi2_calls
    if mu.is_cuda and mu.dtype == torch.float32:
        return rbf_psi2_sum(p, Z, mu, s)
    plain_psi2_calls += 1
    return _rbf_psi2_sum_chunked(p, Z, mu, s, block)
