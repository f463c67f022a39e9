"""Inducing-point (M-axis) sharding, the tensor-parallel analog (port of
``rgp_tpu/parallel/inducing.py``).

The M axis of Z / Psi1 / Psi2 shards over the mesh while the Kmm
factorizations stay replicated:

* Psi1 (T, M): a column block a rank, from its own Z rows (Psi1[t, m]
  depends on z_m alone);
* Psi2 (M, M) = sum_t E[k(x_t, z_m) k(x_t, z_m')]: a ROW block a rank, the
  sum over the whole sequence of its (M_loc, M) slab against the gathered Z,
  which splits the O(T M^2 Q) work M ways;
* the Psi1^T Y blocks and the Psi2 row slabs are gathered and the collapsed
  bound assembles replicated, as ``collapsed_bound_from_suffstats`` does in
  one process.

The rectangular (M_loc, M) slab is plain torch (as it is plain XLA in the
JAX package): K1 is square and mirrors its upper triangle, so it cannot
serve it. Closed forms for the RBF and Linear kernels; others raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..inference.collapsed_vi import collapsed_bound_from_suffstats
from ..kernels import RBF, Kernel, Linear, kern_slice
from ..linalg import hdot
from ..ops.psi_stats import _broadcast_s, _chunked_sum, _psi01
from ..params import positive
from ._collectives import all_gather, axis_size, psum_total, replicate
from .mesh import Mesh, shard_time

__all__ = ["psi2_rows", "inducing_sharded_collapsed_elbo"]


def _rbf_psi2_rows(p, Zr, Zc, mu, s):
    """sum_t Psi2_t[i, j] for the row block Zr (Mr, Q) against the column
    block Zc (Mc, Q): ``ops.psi_stats``'s closed form with the two inducing
    arguments apart; materializes (T, Mr, Mc)."""
    var = positive(p["log_var"])
    ls = positive(p["log_ls"])
    l2 = ls * ls
    w = 1.0 / (l2 + 2.0 * s)  # (T, Q)
    logconst = 2.0 * torch.log(var) - 0.5 * torch.log1p(2.0 * s / l2).sum(-1)
    Zrs, Zcs = Zr / (2.0 * ls), Zc / (2.0 * ls)
    D1 = (Zrs * Zrs).sum(-1)[:, None] + (Zcs * Zcs).sum(-1)[None, :] - 2.0 * hdot(Zrs, Zcs.T)  # (Mr, Mc)
    mu2w = (w * mu * mu).sum(-1)  # (T,)
    Er = hdot(w * mu, Zr.T) - 0.25 * hdot(w, (Zr * Zr).T)  # (T, Mr)
    Ec = hdot(w * mu, Zc.T) - 0.25 * hdot(w, (Zc * Zc).T)  # (T, Mc)
    C = torch.einsum("tq,mq,nq->tmn", w, Zr, Zc)
    log_psi2 = (logconst - mu2w)[:, None, None] - D1[None] + Er[:, :, None] + Ec[:, None, :] - 0.5 * C
    return torch.exp(log_psi2).sum(0)


def _linear_psi2_rows(p, Zr, Zc, mu, s):
    v = positive(p["log_var"])
    p1r = hdot(mu * v, Zr.T)  # (T, Mr)
    p1c = hdot(mu * v, Zc.T)  # (T, Mc)
    return hdot(p1r.T, p1c) + hdot(Zr * v * s.sum(0), (Zc * v).T)


def psi2_rows(kern: Kernel, p, Zr, Zc, mu, s, *, block: Optional[int] = None):
    """Row-block Psi2: sum_t E[k(x_t, Zr) k(x_t, Zc)^T], (Mr, Mc). ``block``
    sums the RBF form over chunks of that many timesteps (the JAX package
    pads the last chunk and masks the padded rows out; here it is shorter)."""
    s = _broadcast_s(mu, s)
    Zra, Zca, mua, sa = (kern_slice(kern, x) for x in (Zr, Zc, mu, s))
    if isinstance(kern, Linear):
        return _linear_psi2_rows(p, Zra, Zca, mua, sa)
    if isinstance(kern, RBF):
        return _chunked_sum(lambda mu_c, s_c: _rbf_psi2_rows(p, Zra, Zca, mu_c, s_c), mua, sa, block)
    raise NotImplementedError(f"inducing-sharded psi2 for kernel {type(kern).__name__} (RBF/Linear only)")


def inducing_sharded_collapsed_elbo(kern: Kernel, kp, Z, log_noise, X_mu, X_s, Y, Y_var, mesh: Mesh, *,
                                    axis: str = "data", block: Optional[int] = None):
    """Collapsed bound with the INDUCING axis sharded over ``axis``: each rank
    takes its rows of ``Z`` (M must divide over the axis), computes its Psi1
    column block and Psi2 row slab, gathers the (M, D) and (M, M)
    statistics, and assembles F0 replicated. ``X_mu/X_s/Y[/Y_var]`` are whole
    on every rank. Returns, on every rank, a scalar equal (up to reduction
    order) to ``collapsed_bound`` on the whole operands, with the
    single-process gradients."""
    T, D = Y.shape
    group = mesh.group(axis)
    kp, Z, log_noise, X_mu, X_s, Y, Y_var = replicate((kp, Z, log_noise, X_mu, X_s, Y, Y_var), group)
    Z_loc = shard_time(mesh, Z, axis)
    Z_full = all_gather(Z_loc, group)
    # psi0 depends on q(X) alone: the same on every rank
    psi0, psi1_loc = _psi01(kern, kp, Z_loc, X_mu, _broadcast_s(X_mu, X_s))
    psi1Y = all_gather(hdot(psi1_loc.T, Y), group)  # (M, D)
    psi2 = all_gather(psi2_rows(kern, kp, Z_loc, Z_full, X_mu, X_s, block=block), group)  # (M, M)
    trYY = (Y * Y).sum()
    if Y_var is not None:
        trYY = trYY + Y_var.sum()
    f0 = collapsed_bound_from_suffstats(kern, kp, Z_full, log_noise, psi0.sum(), psi1Y, psi2, trYY, T, D)
    return psum_total(f0 / axis_size(group), group)
