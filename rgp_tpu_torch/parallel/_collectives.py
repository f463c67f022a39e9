"""The port's collectives, each a ``torch.autograd.Function`` with its adjoint.

These stand where the JAX package's ``shard_map`` bodies call ``jax.lax.psum``,
``all_gather``, ``ppermute`` and ``pmean``. The SPMD idiom is
``torch.distributed``: one process per rank, every rank calling the same
function with the same global tensors. A ``group`` is a
``torch.distributed`` process group, or ``None`` for an axis of one rank,
where every collective is the identity (unlike ``torch.distributed``'s own
``None``, which means the whole world).

Gradients. One ``backward()`` on every rank leaves on every leaf the
single-process gradient. The rules that make it so, where the JAX package
relies on ``shard_map``'s typing of replicated and varying values:

* every leaf enters through :func:`replicate` (the identity forward; the sum
  over ranks of the leaf's gradients backward), and a sharded leaf is sliced
  after it, so it gets its full-size gradient;
* :func:`psum` and :func:`all_gather` are sums over ranks, and their
  adjoints are sums over ranks too;
* a term computed identically on every rank from reduced statistics
  (``repl``) is divided by the axis size, and the returned value is
  ``psum_total(local + repl / n)``: the ``n`` ranks' seeds of the one
  replicated loss count once.

A collective's backward runs on a rank only if a gradient reaches its output
there, and every rank must run it. So every rank uses every collective's
output (a masked ``torch.where`` counts), and :func:`replicate` takes all
leaves in one call, whose backward is one all-reduce whichever leaves a rank
used.

Every collective is an all-reduce: the one that gloo (CPU and CUDA tensors)
and NCCL all have. A gather all-reduces a zero buffer holding each rank's
block at its place; its sum is exact, and every rank gets the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..params import leaves_with_paths, with_leaves

__all__ = ["axis_size", "axis_index", "replicate", "psum", "psum_total", "all_gather"]


def axis_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's place along the axis (``jax.lax.axis_index``)."""
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _gather(x, group):
    n = dist.get_world_size(group)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


class _Replicate(torch.autograd.Function):
    """Forward: every tensor as it is. Backward: each gradient summed over the
    ranks, all of them in one all-reduce (the adjoint of handing one value to
    every rank)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        parts = flat.split([g.numel() for g in gs])
        return (None, *(p.reshape(g.shape).to(g.dtype) for p, g in zip(parts, gs)))


class _Psum(torch.autograd.Function):
    """Forward: the sum over ranks. Backward: the sum over ranks of the
    cotangents (the adjoint of the all-reduce)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, ctx.group)


class _PsumTotal(torch.autograd.Function):
    """Forward: the sum over ranks. Backward: the mean over ranks of the
    cotangents: every rank seeds the replicated result, and those ``n``
    seeds are one loss's."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, ctx.group) / dist.get_world_size(ctx.group)


class _AllGather(torch.autograd.Function):
    """Forward: every rank's block, concatenated in rank order along dim 0.
    Backward: the cotangent summed over ranks, this rank's block of it (the
    adjoint of the gather)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.rows
        return None, _all_reduce(g, ctx.group)[lo:lo + ctx.rows]


def replicate(tree, group):
    """``tree`` (nested dicts, lists and tuples of tensors; ``None`` leaves
    pass) as it is, each gradient of a leaf that requires one summed over
    ranks, all in one all-reduce."""
    leaves = [x for _, x in leaves_with_paths(tree)]
    diff = [x is not None and x.requires_grad for x in leaves]
    if group is None or not any(diff):
        return tree
    out = iter(_Replicate.apply(group, *(x for x, d in zip(leaves, diff) if d)))
    return with_leaves(tree, [next(out) if d else x for x, d in zip(leaves, diff)])


def psum(x, group):
    """``jax.lax.psum``: the sum over the axis."""
    return x if group is None else _Psum.apply(group, x)


def psum_total(x, group):
    """The sum over the axis of each rank's share of a replicated result, the
    value a sharded function returns on every rank (see the module note)."""
    return x if group is None else _PsumTotal.apply(group, x)


def all_gather(x, group):
    """``jax.lax.all_gather(..., tiled=True)``: every rank's ``x`` in rank
    order along dim 0. Booleans are gathered as bytes."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), group).bool()
    return _AllGather.apply(group, x)
