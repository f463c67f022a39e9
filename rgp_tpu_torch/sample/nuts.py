"""No-U-Turn Sampler over a chain axis (port of ``rgp_tpu/sample/nuts.py``).

The JAX package runs one chain's tree doubling as a ``lax.while_loop`` and
vmaps it over chains. Here every chain's tree state is a ``(C, ...)`` tensor,
and one Python loop advances ALL chains still building a tree by one leapfrog
leaf per iteration, through ONE batched gradient of the potential (see
:mod:`rgp_tpu_torch.sample.hmc` for what a batched potential is). A chain
whose tree is done drops out of the batch; its state is left as it was while
the others go on. Each leaf ends in one host read, of two (C,) booleans
(which subtrees completed, which trees stopped), so a transition costs as
many host reads as its longest chain has leaves.

Semantics kept from the reference:

* multinomial (progressive) sampling over tree leaves (Betancourt 2017): a
  subtree's proposal by leaf weight, then a biased take across the doubling,
* the iterative U-turn scheme: a dyadic interval [a, n] of size 2^k completes
  when (n+1) % 2^k == 0, its start state checkpointed when leaf a was added,
  so a stack of max_depth (momentum, cumulative momentum sum) checkpoints
  checks every generalized U-turn without recursion,
* divergence at an energy error above 1000,
* dual-averaging step-size adaptation (Hoffman & Gelman 2014) on the MEDIAN
  accept statistic over chains, with pooled (Chan/Welford) diagonal-mass
  estimation over the warmup window [0.15, 0.9) n_warmup, Stan's shrinkage,
  and the mass switch plus dual-averaging reset at the window's end.

Randomness: chain c's draws at global step i come from its own generator
seeded from (seed, i, chain_offset + c) (``hmc.step_draws``):
its momentum, a direction and an accept uniform per doubling, and one uniform
per leaf, indexed by the leaf's place in the trajectory. So warmup in
segments equals one call, and a chain's transition does not depend on the
other chains in its batch.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..parallel._collectives import all_gather
from .hmc import step_draws, value_and_grad

__all__ = [
    "nuts_sample",
    "NUTSResult",
    "NUTSCarry",
    "nuts_init",
    "nuts_warmup",
    "nuts_draw",
    "nuts_transition",
]

_DIVERGENCE = 1000.0


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (n_chains, n_samples, dim)
    potential: torch.Tensor  # (n_chains, n_samples)
    accept_prob: torch.Tensor  # (n_chains, n_samples)
    diverging: torch.Tensor  # (n_chains, n_samples) bool
    step_size: torch.Tensor  # final adapted step size (0-d)
    mass_inv: torch.Tensor  # final diagonal inverse mass (dim,)


def _is_turning(v_left, v_right, r_sum):
    """Generalized U-turn criterion on velocities, per row."""
    return ((r_sum * v_left).sum(-1) <= 0.0) | ((r_sum * v_right).sum(-1) <= 0.0)


def _select(mask, new, old):
    """Per key, ``new`` where the per-chain ``mask`` (C,) holds, else ``old``."""
    shaped = {}
    out = {}
    for k, v in old.items():
        if k not in new:
            out[k] = v
            continue
        m = shaped.get(v.dim())
        if m is None:
            m = shaped[v.dim()] = mask.reshape(mask.shape + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, new[k], v)
    return out


def nuts_transition(potential_fn: Callable, z, normals, uniforms, step_size, mass_inv, max_depth: int):
    """One NUTS transition of every chain in ``z`` (C, dim).

    ``normals`` (C, dim) give the momenta; ``uniforms`` (C, 2 max_depth +
    2^max_depth) hold each doubling's direction and accept uniforms, then one
    uniform per leaf. Returns (z_prop, U_prop, accept_stat, diverging)."""
    C, dim = z.shape
    dev, dtype = z.device, z.dtype
    u_dir = uniforms[:, :max_depth]
    u_acc = uniforms[:, max_depth:2 * max_depth]
    u_leaf = uniforms[:, 2 * max_depth:]
    rows = torch.arange(C, device=dev)
    pow2 = 2 ** torch.arange(1, max_depth + 1, device=dev)  # dyadic interval sizes

    r0 = torch.sqrt(1.0 / mass_inv) * normals
    U0, g0 = value_and_grad(potential_fn, z)
    H0 = U0 + 0.5 * (mass_inv * r0 * r0).sum(-1)

    false = torch.zeros(C, dtype=torch.bool, device=dev)
    zero = torch.zeros(C, dtype=dtype, device=dev)
    # the tree: endpoints in trajectory order, proposal, weights
    t = dict(z_left=z, r_left=r0, g_left=g0, z_right=z, r_right=r0, g_right=g0, z_prop=z, U_prop=U0,
             log_weight=zero, r_sum=r0, sum_accept=zero, turning=false, diverging=false)
    depth = torch.zeros(C, dtype=torch.long, device=dev)
    n_leaves = torch.ones(C, dtype=torch.long, device=dev)
    active_host = torch.full((C,), max_depth > 0)  # the host's copy of which chains are active
    active = active_host.to(dev)

    def subtree_start():
        """The subtree state every chain would start its next doubling with:
        the walker at the endpoint its direction draw picks."""
        go_right = u_dir[rows, depth.clamp(max=max_depth - 1)] < 0.5
        start = {k: torch.where(go_right[:, None], t[f"{k}_right"], t[f"{k}_left"]) for k in ("z", "r", "g")}
        return dict(go_right=go_right, n=torch.zeros_like(depth), **start, z_prop=start["z"],
                    U_prop=torch.full_like(zero, math.inf), log_weight=torch.full_like(zero, -math.inf),
                    r_sum=torch.zeros_like(z), sum_accept=zero, turning=false, diverging=false,
                    r_ckpt=z.new_zeros((C, max_depth, dim)), s_ckpt=z.new_zeros((C, max_depth, dim)))

    s = subtree_start()
    while active_host.any():
        all_active = bool(active_host.all())
        # one leapfrog leaf for every active chain, one batched gradient
        eps = torch.where(s["go_right"], step_size, -step_size).to(dtype)[:, None]
        r_half = s["r"] - 0.5 * eps * s["g"]
        z_new = s["z"] + eps * mass_inv * r_half
        if all_active:
            U_new, g_new = value_and_grad(potential_fn, z_new)
        else:
            idx = active_host.nonzero().squeeze(1).to(dev)
            U_a, g_a = value_and_grad(potential_fn, z_new[idx])
            U_new = zero.index_copy(0, idx, U_a)
            g_new = torch.zeros_like(z).index_copy(0, idx, g_a)
        r_new = r_half - 0.5 * eps * g_new

        H = U_new + 0.5 * (mass_inv * r_new * r_new).sum(-1)
        delta = H - H0
        delta = torch.where(torch.isnan(delta), math.inf, delta)
        lw_leaf = -delta  # log multinomial weight
        accept_p = torch.clamp(torch.exp(-delta), max=1.0)
        new_lw = torch.logaddexp(s["log_weight"], lw_leaf)
        # a chain's leaves are numbered 1 .. 2^max_depth - 1 along its trajectory
        leaf_u = u_leaf[rows, (n_leaves + s["n"]).clamp(max=2 ** max_depth - 1)]
        take = torch.log(leaf_u) < lw_leaf - new_lw
        n = s["n"]
        # leaf n opens the dyadic intervals of size 2^k with n % 2^k == 0 and
        # closes those with (n+1) % 2^k == 0
        opens = ((n[:, None] % pow2) == 0)[..., None]
        r_ck = torch.where(opens, r_new[:, None, :], s["r_ckpt"])
        s_ck = torch.where(opens, s["r_sum"][:, None, :], s["s_ckpt"])
        r_sum = s["r_sum"] + r_new
        closes = ((n[:, None] + 1) % pow2) == 0
        seg = r_sum[:, None, :] - s_ck
        turn_k = ((seg * (mass_inv * r_ck)).sum(-1) <= 0.0) | ((seg * (mass_inv * r_new)[:, None, :]).sum(-1) <= 0.0)
        leaf = dict(z=z_new, r=r_new, g=g_new, n=n + 1, z_prop=torch.where(take[:, None], z_new, s["z_prop"]),
                    U_prop=torch.where(take, U_new, s["U_prop"]), log_weight=new_lw, r_sum=r_sum,
                    sum_accept=s["sum_accept"] + accept_p, turning=(closes & turn_k).any(-1),
                    diverging=delta > _DIVERGENCE, r_ckpt=r_ck, s_ckpt=s_ck)
        s = {**s, **leaf} if all_active else _select(active, leaf, s)

        # a subtree that is complete merges into its tree; the tree stops at
        # max_depth, a U-turn or a divergence
        done = active & ((s["n"] >= 2 ** depth) | s["turning"] | s["diverging"])
        gr = s["go_right"][:, None]
        ends = dict(z_left=torch.where(gr, t["z_left"], s["z"]), r_left=torch.where(gr, t["r_left"], s["r"]),
                    g_left=torch.where(gr, t["g_left"], s["g"]), z_right=torch.where(gr, s["z"], t["z_right"]),
                    r_right=torch.where(gr, s["r"], t["r_right"]), g_right=torch.where(gr, s["g"], t["g_right"]))
        r_sum_tree = t["r_sum"] + s["r_sum"]
        turning = s["turning"] | _is_turning(mass_inv * ends["r_left"], mass_inv * ends["r_right"], r_sum_tree)
        stop = done & ((depth + 1 >= max_depth) | turning | s["diverging"])
        flags = torch.stack([done, stop]).cpu()  # the one host read of the leaf
        if flags[0].any():
            ok = ~(s["turning"] | s["diverging"])
            acc_u = u_acc[rows, depth.clamp(max=max_depth - 1)]
            take = ok & (torch.log(acc_u) < s["log_weight"] - t["log_weight"])
            merged = dict(
                **ends, z_prop=torch.where(take[:, None], s["z_prop"], t["z_prop"]),
                U_prop=torch.where(take, s["U_prop"], t["U_prop"]),
                log_weight=torch.logaddexp(t["log_weight"], torch.where(ok, s["log_weight"], -math.inf)),
                r_sum=r_sum_tree, sum_accept=t["sum_accept"] + s["sum_accept"], turning=turning,
                diverging=s["diverging"],
            )
            t = _select(done, merged, t)
            n_leaves = torch.where(done, n_leaves + s["n"], n_leaves)
            depth = torch.where(done, depth + 1, depth)
            s = _select(done & ~stop, subtree_start(), s)
            active_host &= ~flags[1]
            active = active & ~stop

    accept_stat = t["sum_accept"] / torch.clamp(n_leaves - 1, min=1).to(dtype)
    return t["z_prop"], t["U_prop"], accept_stat, t["diverging"]


# ------------------------------------------------------------- dual averaging


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_init(step_size0):
    step_size0 = torch.as_tensor(step_size0)
    zero = torch.zeros_like(step_size0)
    return _DAState(log_eps=torch.log(step_size0), log_eps_avg=torch.log(step_size0), h_avg=zero, t=zero,
                    mu=torch.log(10.0 * step_size0))


def _da_update(state: _DAState, accept_stat, target):
    t = state.t + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg + (target - accept_stat) / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, t, state.mu)


def _welford_update(welford, zP):
    """Chan's batch update of the pooled (mean, m2, count) by every chain's
    sample: the cross-chain mean alone would underestimate the posterior
    variance by ~n_chains."""
    mean, m2, cnt = welford
    bm = zP.mean(0)
    bM2 = ((zP - bm[None, :]) ** 2).sum(0)
    k = float(zP.shape[0])
    cnt_new = cnt + k
    delta = bm - mean
    return mean + delta * (k / cnt_new), m2 + bM2 + delta * delta * (cnt * k / cnt_new), cnt_new


# ------------------------------------------------------------------ sampler


class NUTSCarry(NamedTuple):
    """Complete sampler state between calls. ``step`` is the global step
    index (warmup steps, then draws); the draws of a step are a function of
    (seed, step, chain), so a run cut into segments equals one call."""

    zs: torch.Tensor  # (n_chains, dim) current positions
    da: _DAState  # dual-averaging state, 0-d tensors on the chains' device
    welford: tuple  # (mean (dim,), m2 (dim,), count 0-d) pooled mass estimator
    mass_inv: torch.Tensor  # (dim,) diagonal inverse mass
    step: int


def nuts_init(z0, *, n_chains: int = 1, step_size: float = 0.1, mass_inv=None) -> NUTSCarry:
    """``mass_inv``: optional initial diagonal inverse mass (dim,), e.g. the
    inverse Hessian diagonal of the potential at a MAP estimate: GP
    hyperparameter posteriors are stiff, and with a unit mass the dual
    averaging collapses the step size before the Welford window can learn
    the scales."""
    z0 = torch.atleast_2d(torch.as_tensor(z0))
    if z0.shape[0] != n_chains:
        z0 = z0.expand(n_chains, z0.shape[-1])
    dim, dtype, dev = z0.shape[-1], z0.dtype, z0.device
    zeros = torch.zeros(dim, dtype=dtype, device=dev)
    return NUTSCarry(
        zs=z0.detach().clone(),
        da=_da_init(torch.tensor(step_size, dtype=dtype, device=dev)),
        welford=(zeros, zeros.clone(), torch.zeros((), dtype=dtype, device=dev)),
        mass_inv=torch.ones(dim, dtype=dtype, device=dev) if mass_inv is None
        else torch.as_tensor(mass_inv, dtype=dtype, device=dev),
        step=0,
    )


def _transition(potential_fn, zs, seed, step, chain_offset, step_size, mass_inv, max_depth):
    normals, uniforms = step_draws(seed, step, zs.shape[0], chain_offset, zs.shape[1],
                                   2 * max_depth + 2 ** max_depth, zs.dtype, zs.device)
    return nuts_transition(potential_fn, zs, normals, uniforms, step_size, mass_inv, max_depth)


def nuts_warmup(potential_fn: Callable, carry: NUTSCarry, seed: int, n_steps: int, *, n_warmup: int,
                max_depth: int = 8, target_accept: float = 0.8, adapt_mass: bool = True,
                chain_offset: int = 0, group=None) -> NUTSCarry:
    """Advance ``n_steps`` warmup steps from ``carry`` (dual averaging on the
    median accept statistic over chains + pooled-Welford mass estimation).
    ``n_warmup`` is the TOTAL warmup length: it fixes the adaptation schedule
    (window [0.15, 0.9) n_warmup) and must be the same across segments. The
    median is robust to "sink" chains stuck where the float32 potential
    diverges, which report accept ~0 forever (the JAX package measured a mean
    death-spiral the shared step size).

    ``group``: the chain axis's process group when the chains are sharded
    over ranks (``sample.api.nuts_sharded``; this rank's chains start at
    ``chain_offset``). Every step then gathers every chain's accept
    statistic, and in the Welford window every chain's position, in global
    chain order, so the median and the pooled moments are those of one
    process running all the chains, the same bits on every rank (the JAX
    package gathers the accept statistics too, and reduces the batch mean
    and M2 instead: a pmean of per-rank medians would still be dragged down
    when sink chains cluster on one rank)."""
    mid_lo, mid_hi = int(0.15 * n_warmup), int(0.9 * n_warmup)
    zs, da, welford, mass_inv, i = carry
    for _ in range(n_steps):
        zP, _, acc, _ = _transition(potential_fn, zs, seed, i, chain_offset, torch.exp(da.log_eps), mass_inv,
                                    max_depth)
        # jnp.median: the mean of the two middle values for an even count
        da = _da_update(da, torch.quantile(all_gather(acc, group), 0.5), target_accept)
        if mid_lo <= i < mid_hi:
            welford = _welford_update(welford, all_gather(zP, group))
        if i == mid_hi:
            # switch in the new mass matrix and restart dual averaging from
            # the averaged step size
            if adapt_mass:
                var = welford[1] / torch.clamp(welford[2] - 1.0, min=1.0)
                var = torch.where(welford[2] > 2.0, var, torch.ones_like(var))
                n = welford[2]
                mass_inv = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))  # Stan-style shrinkage
            da = _da_init(torch.exp(da.log_eps_avg))
        zs, i = zP, i + 1
    return NUTSCarry(zs, da, welford, mass_inv, i)


def nuts_draw(potential_fn: Callable, carry: NUTSCarry, seed: int, n_samples: int, *, max_depth: int = 8,
              chain_offset: int = 0):
    """Draw ``n_samples`` post-warmup samples, continuing ``carry`` (the step
    counter keeps advancing, so draws are segmentation-invariant too).
    Returns (carry, NUTSResult)."""
    eps_final = torch.exp(carry.da.log_eps_avg)
    zs, i = carry.zs, carry.step
    draws = []  # (z, U, accept_stat, diverging) per step
    for _ in range(n_samples):
        draws.append(_transition(potential_fn, zs, seed, i, chain_offset, eps_final, carry.mass_inv,
                                 max_depth))
        zs, i = draws[-1][0], i + 1
    C, dim = zs.shape
    empty = (zs.new_zeros((C, 0, dim)), zs.new_zeros((C, 0)), zs.new_zeros((C, 0)),
             torch.zeros((C, 0), dtype=torch.bool, device=zs.device))
    cols = [torch.stack(x, 1) for x in zip(*draws)] if draws else empty
    return carry._replace(zs=zs, step=i), NUTSResult(*cols, eps_final, carry.mass_inv)


def nuts_sample(potential_fn: Callable, z0, seed: int, *, n_samples: int = 500, n_warmup: int = 300,
                max_depth: int = 8, step_size: float = 0.1, target_accept: float = 0.8, n_chains: int = 1,
                adapt_mass: bool = True, chain_offset: int = 0, mass_inv0=None, group=None) -> NUTSResult:
    """NUTS with dual-averaging warmup: :func:`nuts_init`, then
    :func:`nuts_warmup`, then :func:`nuts_draw`. ``z0``: (dim,) or
    (n_chains, dim); ``potential_fn`` is batched, (C, dim) -> (C,).
    ``group``: the chain axis's process group when the chains are sharded
    (see :func:`nuts_warmup`); the result holds this rank's chains."""
    carry = nuts_init(z0, n_chains=n_chains, step_size=step_size, mass_inv=mass_inv0)
    carry = nuts_warmup(potential_fn, carry, seed, n_warmup, n_warmup=n_warmup, max_depth=max_depth,
                        target_accept=target_accept, adapt_mass=adapt_mass, chain_offset=chain_offset,
                        group=group)
    _, res = nuts_draw(potential_fn, carry, seed, n_samples, max_depth=max_depth, chain_offset=chain_offset)
    return res
