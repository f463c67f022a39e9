"""Process mesh and the time-sharded collapsed bound (port of
``rgp_tpu/parallel/mesh.py``).

Axes, as in the JAX package:

  'data'     - time shards of the collapsed bound (psum of the additive
               psi-statistic partial sums) and of the sequence-sharded RGP
  'chain'    - MCMC chains (``sample.api.nuts_sharded``)
  'particle' - SMC particles (``sample.smc.smc_filter_sharded``)

The JAX package runs one controller over a device mesh; here each rank is a
process (``torch.distributed``), started by the caller, that calls
:func:`init_distributed` once and then :func:`make_mesh`. Every sharded entry
point is called by every rank with the same global tensors, takes its own
block inside, and returns the replicated result on every rank
(:mod:`rgp_tpu_torch.parallel._collectives` says how its gradients are kept
equal to the single-process ones).
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch.distributed as dist

from ..inference.collapsed_vi import collapsed_bound_from_suffstats
from ..kernels import Kernel
from ..linalg import hdot
from ..ops.psi_stats import psi_statistics
from ._collectives import axis_size, psum, psum_total, replicate

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "data_parallel_collapsed_elbo",
    "shard_time",
]

AXES = ("data", "chain", "particle")


def init_distributed(backend: str, *, timeout: float = 600.0, **kw):
    """``torch.distributed.init_process_group(backend, timeout=..., **kw)``
    (``init_method``, ``rank``, ``world_size``, ...); a no-op when a group is
    already initialized. ``timeout`` (seconds) bounds every collective, so a
    rank that is gone fails the others instead of hanging them. The caller
    names the backend: ``"nccl"`` for one card a rank, ``"gloo"`` for the CPU,
    or for several ranks on one card (NCCL refuses two ranks on one device;
    gloo's all-reduce takes CUDA tensors)."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout), **kw)


class Mesh:
    """Ranks laid out as (data, chain, particle), row-major over the world as
    the JAX package lays devices out. ``shape`` is the JAX mesh's dict;
    :meth:`group` is an axis's process group (``None`` for an axis of one
    rank in a larger world), :meth:`index` this rank's place along it."""

    def __init__(self, shape, groups, coords):
        self.shape = dict(shape)
        self._groups = groups
        self._coords = coords

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self._coords[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]


def make_mesh(data: int = 1, chain: int = 1, particle: int = 1) -> Mesh:
    """The mesh over the world's ranks; ``data * chain * particle`` must be
    the world size (1 without :func:`init_distributed`: one process, where
    every collective is the identity). An axis as large as the world uses the
    world's group, so on one rank the collectives still go through the
    backend; a group is made for each line of an axis between, by every
    rank, in the same order."""
    shape = {"data": data, "chain": chain, "particle": particle}
    n = data * chain * particle
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks, the world has {world}")
    if not dist.is_initialized():
        return Mesh(shape, {a: None for a in AXES}, {a: 0 for a in AXES})
    ranks = np.arange(world).reshape(data, chain, particle)
    me = dist.get_rank()
    coords = dict(zip(AXES, (int(i) for i in np.argwhere(ranks == me)[0])))
    groups = {}
    for k, axis in enumerate(AXES):
        size = shape[axis]
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        groups[axis] = None
        if size == 1:
            continue
        lines = np.moveaxis(ranks, k, -1).reshape(-1, size)
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = g
    return Mesh(shape, groups, coords)


def shard_time(mesh: Mesh, x, axis: str = "data"):
    """This rank's block of dim 0 of ``x`` along ``axis`` (the JAX package
    places the array with its leading axis sharded). Raises unless the axis
    size divides dim 0."""
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of length {x.shape[0]} does not divide over the {n} ranks of '{axis}'")
    block = x.shape[0] // n
    lo = mesh.index(axis) * block
    return x[lo:lo + block]


def data_parallel_collapsed_elbo(kern: Kernel, kp, Z, log_noise, X_mu, X_s, Y, Y_var, mesh: Mesh, *,
                                 T_total: Optional[int] = None, block: Optional[int] = None):
    """Collapsed bound with time-sharded inputs: each rank computes the
    additive sufficient statistics (sum psi0, Psi1^T Y, sum Psi2, E||Y||^2)
    on its block of ``X_mu/X_s/Y[/Y_var]``, psums them over 'data', and
    assembles F0 replicated (the reference's MPI sufficient-statistic
    Allreduce). Every rank passes the global tensors; dim 0 must divide over
    the axis. On float32 CUDA tensors each rank's Psi2 sum runs through K1 and,
    in the backward, K2. Returns, on every rank, a scalar equal (up to
    reduction order) to ``collapsed_bound`` on the whole arrays, with the
    single-process gradients."""
    T, D = Y.shape
    if T_total is None:
        T_total = T
    group = mesh.group("data")
    kp, Z, log_noise, X_mu, X_s, Y, Y_var = replicate((kp, Z, log_noise, X_mu, X_s, Y, Y_var), group)
    Xm, Yl = shard_time(mesh, X_mu), shard_time(mesh, Y)
    Xs = None if X_s is None else shard_time(mesh, X_s)
    stats = psi_statistics(kern, kp, Z, Xm, Xs, block=block)
    trYY = (Yl * Yl).sum()
    if Y_var is not None:
        trYY = trYY + shard_time(mesh, Y_var).sum()
    f0 = collapsed_bound_from_suffstats(
        kern, kp, Z, log_noise, psum(stats.psi0.sum(), group), psum(hdot(stats.psi1.T, Yl), group),
        psum(stats.psi2, group), psum(trYY, group), T_total, D,
    )
    return psum_total(f0 / axis_size(group), group)
