"""Sequence-sharded REVARB ELBO with halo exchange (port of
``rgp_tpu/parallel/sequence.py``).

REVARB's mean-field q(x_t) factorizes the bound over timesteps, so the time
axis shards over the mesh's 'data' axis. Each rank's lag windows need the
last ``max(L_h, L_u - 1)`` states of its LEFT neighbour: a halo, gathered from
every rank's tail rows (the JAX package sends them one rank to the right with
``ppermute``; a gather of a few rows is a collective every backend has, gloo
on CUDA tensors included). Partial psi-statistics and the per-timestep
entropy terms then reduce over the axis, and the bound assembles replicated.
Back-constrained (encoder) means halo-exchange their (Y, U) windows the same
way; with ``amortize_var`` the encoder gives the variances too.

On float32 CUDA tensors each rank's Psi2 sums run through K1 (one launch a
layer a forward) and K2 (one a layer a backward) on its own block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..data.windows import current_window, lagged
from ..inference.collapsed_vi import collapsed_bound_from_suffstats
from ..linalg import hdot
from ..models import rgp as rgp_model
from ..models.encoder import mlp_apply
from ..ops.psi_stats import psi_statistics
from ._collectives import all_gather, axis_index, axis_size, psum, psum_total, replicate
from .mesh import Mesh, shard_time

__all__ = ["sequence_sharded_rgp_elbo"]


def _halo_from_left(x_loc, halo: int, group, first_fill):
    """The last ``halo`` rows of the LEFT neighbour's block; the first rank
    takes ``first_fill`` (shape (halo, D)) instead. Every rank takes its row
    of the gathered tails (rank 0 the last rank's, as in the JAX package's
    ring) and masks it, so every rank's gradient reaches the gather."""
    if halo == 0:
        return x_loc.new_zeros((0,) + tuple(x_loc.shape[1:]))
    n, idx = axis_size(group), axis_index(group)
    tails = all_gather(x_loc[-halo:], group).reshape((n, halo) + tuple(x_loc.shape[1:]))
    recv = tails[(idx - 1) % n]
    first = torch.tensor(idx == 0, device=x_loc.device)
    return torch.where(first, first_fill.to(x_loc.dtype), recv)


def _windows_local(x_loc, halo_rows, L: int, mode: str):
    """Per-timestep windows of the local block given its left halo.
    mode='lagged': [x_{t-1..t-L}];  mode='current': [x_t..x_{t-L+1}]."""
    ext = torch.cat([halo_rows, x_loc], dim=0)
    if mode == "lagged":
        return lagged(ext, L)[halo_rows.shape[0]:]
    return current_window(ext, L)[halo_rows.shape[0]:]


def _check_shapes(cfg: rgp_model.RGPConfig, T: int, n: int):
    if T % n:
        raise ValueError(f"sequence length {T} does not divide over the {n} ranks of the axis")
    halos = {"u_win - 1": cfg.u_win - 1, "out_win - 1": cfg.out_win - 1}
    for h, spec in enumerate(cfg.layers):
        halos[f"layers[{h}].win"] = spec.win
    longest = max(halos, key=halos.get)
    if halos[longest] > T // n:
        raise ValueError(f"a halo of {halos[longest]} rows ({longest}) is longer than a rank's block of "
                         f"{T // n} timesteps")


def sequence_sharded_rgp_elbo(cfg: rgp_model.RGPConfig, params, Y, U, mesh: Mesh, *, axis: str = "data",
                              block: Optional[int] = None):
    """REVARB ELBO with the time axis sharded over ``axis``.

    Every rank passes the global ``Y``/``U`` and the whole ``params``; the
    per-timestep variational state (``params['layers'][h]['mu'/'log_lam']``)
    and the data are cut into blocks inside, so their length must divide
    over the axis, and no halo (``win``, ``u_win - 1``, ``out_win - 1``) may
    be longer than a block. Returns, on every rank, a scalar equal (up to
    reduction order) to ``rgp.elbo(cfg, params, Y, U, block=block)``; one
    ``backward()`` on every rank leaves every leaf's single-process gradient
    (the sharded ``mu``/``log_lam`` their full-size one)."""
    group = mesh.group(axis)
    n = axis_size(group)
    T = Y.shape[0]
    _check_shapes(cfg, T, n)
    specs = cfg.layers
    p, Y, U = replicate((params, Y, U), group)
    p = _place(p, _params_spec(cfg, axis), mesh)
    Y_loc, U_loc = shard_time(mesh, Y, axis), shard_time(mesh, U, axis)
    dev, dtype = Y.device, Y.dtype

    def zeros(rows, cols):
        return torch.zeros((rows, cols), dtype=dtype, device=dev)

    # terms assembled identically on every rank from reduced statistics
    # ("repl") count once through the division by n (see _collectives)
    repl = 0.0
    local = 0.0

    mu_ts, lam_ts = [], []
    for h, spec in enumerate(specs):
        lp = p["layers"][h]
        lam_t = torch.exp(lp["log_lam"])
        if cfg.back_cstr:
            feats = []
            if spec.win > 0:
                haloY = _halo_from_left(Y_loc, spec.win, group, zeros(spec.win, cfg.y_dim))
                feats.append(_windows_local(Y_loc, haloY, spec.win, "lagged"))
            if cfg.u_win > 0:
                haloU = _halo_from_left(U_loc, cfg.u_win - 1, group, zeros(max(cfg.u_win - 1, 0), cfg.u_dim))
                feats.append(_windows_local(U_loc, haloU, cfg.u_win, "current"))
            out = mlp_apply(p["encoder"][h], torch.cat(feats, dim=-1))
            if cfg.amortize_var:
                mu_ts.append(out[:, :spec.q_dim])
                lam_t = torch.exp(out[:, spec.q_dim:] + rgp_model._LOG_LAM_BIAS)
            else:
                mu_ts.append(out)
        else:
            mu_ts.append(lp["mu"])
        lam_ts.append(lam_t)

    mu_lower = lam_lower = None
    for h, spec in enumerate(specs):
        lp = p["layers"][h]
        L = spec.win
        mu_t, lam_t = mu_ts[h], lam_ts[h]
        # own lag windows: the halo is the left neighbour's last L latents,
        # the first rank's the initial window mu0 (stored oldest-first)
        own_mu = _windows_local(mu_t, _halo_from_left(mu_t, L, group, lp["mu0"]), L, "lagged")
        own_s = _windows_local(lam_t, _halo_from_left(lam_t, L, group, torch.exp(lp["log_lam0"])), L, "lagged")
        if h == 0:
            haloU = _halo_from_left(U_loc, cfg.u_win - 1, group, zeros(max(cfg.u_win - 1, 0), cfg.u_dim))
            low_mu = _windows_local(U_loc, haloU, cfg.u_win, "current")
            low_s = torch.zeros_like(low_mu)
        else:
            q_lo = specs[h - 1].q_dim
            low_mu = _windows_local(mu_lower, _halo_from_left(mu_lower, L - 1, group, zeros(L - 1, q_lo)), L,
                                    "current")
            low_s = _windows_local(lam_lower, _halo_from_left(lam_lower, L - 1, group, zeros(L - 1, q_lo)), L,
                                   "current")
        stats = psi_statistics(spec.kernel, lp["kern"], lp["Z"], torch.cat([own_mu, low_mu], dim=-1),
                               torch.cat([own_s, low_s], dim=-1), block=block)
        repl = repl + collapsed_bound_from_suffstats(
            spec.kernel, lp["kern"], lp["Z"], rgp_model._fln(cfg, lp["log_noise"]),
            psum(stats.psi0.sum(), group), psum(hdot(stats.psi1.T, mu_t), group), psum(stats.psi2, group),
            psum((mu_t * mu_t).sum() + lam_t.sum(), group), T, spec.q_dim,
        )
        # entropy over this rank's targets; KL of the replicated initial window
        local = local + 0.5 * torch.log(2.0 * math.pi * math.e * lam_t).sum()
        mu0, lam0 = lp["mu0"], torch.exp(lp["log_lam0"])
        repl = repl - 0.5 * (mu0 * mu0 + lam0 - torch.log(lam0) - 1.0).sum()
        mu_lower, lam_lower = mu_t, lam_t

    op = p["out"]
    W = cfg.out_win
    q_top = specs[-1].q_dim
    Xo_mu = _windows_local(mu_lower, _halo_from_left(mu_lower, W - 1, group, zeros(W - 1, q_top)), W, "current")
    Xo_s = _windows_local(lam_lower, _halo_from_left(lam_lower, W - 1, group, zeros(W - 1, q_top)), W, "current")
    stats = psi_statistics(cfg.out_kernel, op["kern"], op["Z"], Xo_mu, Xo_s, block=block)
    repl = repl + collapsed_bound_from_suffstats(
        cfg.out_kernel, op["kern"], op["Z"], rgp_model._fln(cfg, op["log_noise"]),
        psum(stats.psi0.sum(), group), psum(hdot(stats.psi1.T, Y_loc), group), psum(stats.psi2, group),
        psum((Y_loc * Y_loc).sum(), group), T, cfg.y_dim,
    )
    return psum_total(local + repl / n, group)


def _params_spec(cfg: rgp_model.RGPConfig, axis: str):
    """The axis each parameter leaf is sharded over, ``None`` where it is
    replicated (the JAX package's PartitionSpec tree): the per-timestep
    variational state is sharded, everything else replicated."""
    layer = {"kern": None, "Z": None, "log_noise": None, "mu0": None, "log_lam0": None, "mu": axis,
             "log_lam": axis}
    spec = {"layers": [dict(layer) for _ in cfg.layers], "out": {"kern": None, "Z": None, "log_noise": None}}
    if cfg.back_cstr:
        spec["encoder"] = None
    return spec


def _place(tree, spec, mesh: Mesh):
    """``tree`` with each leaf that ``spec`` shards cut to this rank's block."""
    if spec is None:
        return tree
    if isinstance(spec, str):
        return shard_time(mesh, tree, spec)
    if isinstance(tree, dict):
        return {k: _place(v, spec[k], mesh) for k, v in tree.items()}
    return type(tree)(_place(v, s, mesh) for v, s in zip(tree, spec))
