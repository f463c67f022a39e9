"""Training loops (port of ``rgp_tpu/train.py``: Adam).

:func:`fit_adam` is the counterpart of the JAX package's ``fit_adam``: Adam
with optax's semantics (eps outside the square root, optax's bias
correction; the step at count i uses the learning rate of count i), an
optional frozen-leaf mask and an optional stop-gradient ``aux_fn`` refreshed
every ``aux_every`` steps. The JAX package runs the loop as one ``lax.scan``
under jit; here it is a Python loop that never waits for the card: no
``.item()`` and no ``float()`` inside it, and the losses go into a
preallocated tensor on the parameters' device.

Parameters are the port's nested dicts and lists of tensors; leaves are named
by '/'-joined key paths (``"layers/0/Z"``, ``"out/kern/log_ls"``) as in the
JAX package.

``fit_minibatch``, ``fit_scg``, ``fit_scipy_lbfgs`` and ``optimize_restarts``
are not ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["FitResult", "fit_adam", "freeze_mask", "cosine_decay_schedule", "leaves_with_paths",
           "with_leaves"]


class FitResult(NamedTuple):
    params: object
    losses: torch.Tensor  # (iters,): loss at the parameters before each update


def leaves_with_paths(tree, prefix=""):
    """[(path, leaf)] in the JAX package's order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def with_leaves(tree, leaves):
    """``tree``'s nesting with its leaves replaced, in :func:`leaves_with_paths` order."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)


def freeze_mask(params, predicate: Callable[[str], bool]):
    """A tree of booleans shaped like ``params``: True where ``predicate`` of
    the leaf's '/'-joined key path (e.g. ``"layers/0/Z"``) asks to freeze it.
    The functional analog of paramz ``param.fix()``."""
    return with_leaves(params, [bool(predicate(path)) for path, _ in leaves_with_paths(params)])


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: ``init_value * ((1 - alpha) *
    0.5 (1 + cos(pi min(i, decay_steps) / decay_steps)) + alpha)`` at step i,
    as a host function of the step index."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def fit_adam(
    loss_fn: Callable,
    params,
    *,
    iters: int,
    learning_rate=1e-2,
    frozen=None,
    aux_fn: Optional[Callable] = None,
    aux_every: int = 1,
) -> FitResult:
    """Minimize ``loss_fn(params)`` with Adam (b1 0.9, b2 0.999, eps 1e-8).

    ``learning_rate``: a float or a schedule ``f(step) -> float`` (e.g.
    :func:`cosine_decay_schedule`). ``frozen``: optional tree of booleans
    (:func:`freeze_mask`); True leaves get a zero gradient and stay fixed.
    ``aux_fn``: optional ``aux_fn(params) -> aux`` recomputed under
    ``torch.no_grad()`` before steps 0, ``aux_every``, 2 ``aux_every``, ...;
    the loss is then ``loss_fn(params, aux)``. Used for the stop-gradient
    spectral whitening bases (``rgp.compute_whitenings``). Exactly ``iters``
    updates run.

    ``params`` is not modified; the result holds detached copies.
    """
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    flat = leaves_with_paths(params)
    leaves = [x.detach().clone().requires_grad_(True) for _, x in flat]
    p = with_leaves(params, leaves)
    fixed = [False] * len(leaves) if frozen is None else [bool(f) for _, f in leaves_with_paths(frozen)]
    if len(fixed) != len(leaves):
        raise ValueError("frozen does not match the structure of params")
    opt = torch.optim.Adam(leaves, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    losses = None
    aux = None
    for i in range(iters):
        if aux_fn is not None and i % aux_every == 0:
            with torch.no_grad():
                aux = aux_fn(p)
        loss = loss_fn(p) if aux_fn is None else loss_fn(p, aux)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for x, g, f in zip(leaves, grads, fixed):
            x.grad = torch.zeros_like(x) if (f or g is None) else g
        if losses is None:
            losses = torch.empty(iters, dtype=loss.dtype, device=loss.device)
        losses[i] = loss.detach()
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
    if losses is None:
        losses = torch.empty(0, dtype=leaves[0].dtype, device=leaves[0].device)
    return FitResult(params=with_leaves(params, [x.detach() for x in leaves]), losses=losses)
