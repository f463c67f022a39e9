"""Training loops (port of ``rgp_tpu/train.py``).

* :func:`fit_adam`: Adam on a loss of the whole data, with an optional
  frozen-leaf mask and a stop-gradient ``aux_fn`` refreshed every
  ``aux_every`` steps.
* :func:`fit_minibatch`: Adam on minibatches drawn with replacement, with an
  optional natural-gradient block (config 4's q(u)).
* :func:`optimize_restarts`: Adam from several inits trained as one batch
  (:func:`stack_restarts`, ``torch.func.vmap`` of the loss), the best final
  loss kept.
* :func:`fit_scg` and :func:`fit_scipy_lbfgs`: scaled conjugate gradients and
  scipy's L-BFGS-B over the flat vector of :func:`rgp_tpu_torch.params.ravel`.

Every Adam step is :class:`OptaxAdam`: optax's ``adam`` (eps outside the
square root, optax's bias correction; the step at count i uses the learning
rate of count i), after optax's ``clip_by_global_norm`` when ``clip_norm`` is
given. The JAX package runs each loop as one ``lax.scan`` under jit; here
they are Python loops that never wait for the card: no ``.item()`` and no
``float()`` inside them (except L-BFGS, a host loop by nature), the state of
SCG stays in device tensors, and the losses go into a preallocated tensor on
the parameters' device.

Parameters are the port's nested dicts and lists of tensors; leaves are named
by '/'-joined key paths (``"layers/0/Z"``, ``"out/kern/log_ls"``) as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .params import leaves_with_paths, ravel, with_leaves

__all__ = ["FitResult", "OptaxAdam", "batch_indices", "fit_adam", "fit_minibatch", "fit_scg", "fit_scipy_lbfgs",
           "optimize_restarts", "stack_restarts", "restart", "freeze_mask", "cosine_decay_schedule",
           "leaves_with_paths", "with_leaves"]


class FitResult(NamedTuple):
    params: object
    losses: torch.Tensor  # (iters,): loss at the parameters before each update


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


class OptaxAdam:
    """One Adam step at a time over ``leaves`` with optax's semantics (b1 0.9,
    b2 0.999, eps 1e-8). ``learning_rate`` is a float or a schedule ``f(step)
    -> float``. With ``clip_norm``, the gradients first go through optax's
    ``clip_by_global_norm``: when their global norm reaches ``clip_norm``,
    each is replaced by ``g / norm * clip_norm`` (a device ``where``, no host
    read)."""

    def __init__(self, leaves, learning_rate=1e-2, clip_norm: Optional[float] = None):
        self.leaves = leaves
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.clip_norm = clip_norm
        self.opt = torch.optim.Adam(leaves, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def step(self, grads, i: int):
        """Apply the update of step ``i`` for ``grads`` (one per leaf)."""
        if self.clip_norm is not None:
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, g / g_norm * self.clip_norm) for g in grads]
        for x, g in zip(self.leaves, grads):
            x.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(i)
        self.opt.step()


def _trainable(params):
    """Detached copies of ``params``' leaves that require grad, and the tree
    of them."""
    leaves = [x.detach().clone().requires_grad_(True) for _, x in leaves_with_paths(params)]
    return leaves, with_leaves(params, leaves)


def _grads(loss, leaves, zeroed):
    """d loss / d leaves; a zero where ``zeroed`` says so or the leaf is unused."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if (z or g is None) else g for x, g, z in zip(leaves, grads, zeroed)]


def _losses_for(losses, iters, loss):
    if losses is None:
        losses = torch.empty(iters, dtype=loss.dtype, device=loss.device)
    return losses


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
    """Minimize ``loss_fn(params)`` with :class:`OptaxAdam`.

    ``learning_rate``: a float or a schedule ``f(step) -> float`` (e.g.
    :func:`cosine_decay_schedule`). ``frozen``: optional tree of booleans
    (:func:`freeze_mask`); True leaves get a zero gradient and stay fixed.
    ``aux_fn``: optional ``aux_fn(params) -> aux`` recomputed under
    ``torch.no_grad()`` before steps 0, ``aux_every``, 2 ``aux_every``, ...;
    the loss is then ``loss_fn(params, aux)``. Used for the stop-gradient
    spectral whitening bases (``rgp.compute_whitenings``). Exactly ``iters``
    updates run (the JAX package's ``fit_adam`` pads the last ``aux_every``
    chunk and applies the padded updates: ROADMAP.md Queue 3).

    A loss with a shape (e.g. (R,) for R restarts stacked on a leading axis,
    :func:`stack_restarts`) is summed for the gradient, so each independent
    instance gets its own gradient, and ``losses`` is then (iters, R).

    ``params`` is not modified; the result holds detached copies.
    """
    leaves, p = _trainable(params)
    fixed = [False] * len(leaves) if frozen is None else [bool(f) for _, f in leaves_with_paths(frozen)]
    if len(fixed) != len(leaves):
        raise ValueError("frozen does not match the structure of params")
    opt = OptaxAdam(leaves, learning_rate)
    losses = None
    aux = None
    for i in range(iters):
        if aux_fn is not None and i % aux_every == 0:
            with torch.no_grad():
                aux = aux_fn(p)
        loss = loss_fn(p) if aux_fn is None else loss_fn(p, aux)
        grads = _grads(loss.sum(), leaves, fixed)
        losses = _losses_for(losses, (iters, *loss.shape), loss)
        losses[i] = loss.detach()
        opt.step(grads, i)
    if losses is None:
        losses = torch.empty(0, dtype=leaves[0].dtype, device=leaves[0].device)
    return FitResult(params=with_leaves(params, [x.detach() for x in leaves]), losses=losses)


def stack_restarts(trees):
    """One tree whose leaves are the ``trees``' leaves stacked on a leading
    restart axis."""
    per = [[x for _, x in leaves_with_paths(t)] for t in trees]
    return with_leaves(trees[0], [torch.stack(xs) for xs in zip(*per)])


def restart(stacked, r: int):
    """Restart ``r`` of a tree stacked by :func:`stack_restarts`."""
    return with_leaves(stacked, [x[r] for _, x in leaves_with_paths(stacked)])


def optimize_restarts(
    loss_fn: Callable,
    init_fn: Callable,
    seeds,
    *,
    iters: int,
    learning_rate=1e-2,
    accept_fn: Optional[Callable] = None,
) -> FitResult:
    """Adam from ``init_fn(seed)`` for every seed, all restarts trained as one
    batch, as the JAX package's ``vmap`` of one scan: the inits stacked leaf
    by leaf (:func:`stack_restarts`), each step the gradient of the sum of
    ``torch.func.vmap(loss_fn)`` over the restarts (each restart's own
    gradient) and one :class:`OptaxAdam` step on the stacked leaves (Adam is
    elementwise, so each restart gets its own update). The restart with the
    least final loss is returned, with its losses. ``accept_fn(params) ->
    bool`` (a tensor or a Python bool), vmapped over the restarts, vetoes a
    restart before selection; if it vetoes them all, the least final loss
    wins regardless."""
    stacked = stack_restarts([init_fn(s) for s in seeds])
    params_b, losses = fit_adam(torch.func.vmap(loss_fn), stacked, iters=iters, learning_rate=learning_rate)
    final = losses[-1]
    if accept_fn is not None:
        ok = torch.func.vmap(lambda q: torch.as_tensor(accept_fn(q)))(params_b).to(final.device)
        score = torch.where(ok, final, torch.full_like(final, float("inf")))
        final = torch.where(ok.any(), score, final)
    best = int(torch.argmin(final))
    return FitResult(params=restart(params_b, best), losses=losses[:, best])


def batch_indices(data, iters: int, batch_size: int, *, generator: Optional[torch.Generator] = None,
                  seed: int = 0, indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(iters, batch_size)`` rows of ``data`` (a tensor whose leading
    axis is the datapoints) that minibatch training visits, on ``data``'s
    device: drawn with replacement, all at once, from ``generator`` (default:
    a generator on ``data``'s device seeded with ``seed``), or ``indices``
    when given (e.g. the JAX package's draws, replayed)."""
    if indices is None:
        if generator is None:
            generator = torch.Generator(device=data.device).manual_seed(seed)
        indices = torch.randint(0, data.shape[0], (iters, batch_size), generator=generator,
                                device=generator.device)
    elif tuple(indices.shape) != (iters, batch_size):
        raise ValueError(f"indices has shape {tuple(indices.shape)}, want {(iters, batch_size)}")
    return indices.to(data.device)


def fit_minibatch(
    loss_fn: Callable,
    params,
    data,
    *,
    iters: int,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    indices: Optional[torch.Tensor] = None,
    learning_rate=1e-2,
    clip_norm: Optional[float] = None,
    natgrad_block: Optional[str] = None,
    natgrad_lr=0.1,
    natgrad_loss: Optional[Callable] = None,
    aux_fn: Optional[Callable] = None,
    aux_every: int = 1,
) -> FitResult:
    """Stochastic minibatch training: :class:`OptaxAdam` (with ``clip_norm``
    if given) on ``loss_fn(params, batch)``, where ``batch`` is ``data`` (a
    tree of tensors whose leading axis is the datapoints) gathered at
    ``batch_size`` indices drawn with replacement.

    The indices of all ``iters`` steps are drawn at once on ``generator``'s
    device (default: a generator on the data's device seeded with ``seed``);
    ``indices`` (an ``(iters, batch_size)`` integer tensor) replays given
    draws instead, e.g. the JAX package's ``jax.random`` stream
    (:func:`batch_indices`).

    ``aux_fn``: as in :func:`fit_adam`; the loss is then ``loss_fn(params,
    batch, aux)``. Exactly ``iters`` updates run.

    ``natgrad_block``: optional name of a params sub-key (``'qu'``) that Adam
    does not move (its gradient is zeroed before the clip and the step);
    instead, after each Adam step, :func:`rgp_tpu_torch.inference.natgrad.natgrad_step`
    updates it on the same batch at the updated parameters.
    ``natgrad_loss(params, batch)`` defaults to ``-loss_fn(params, batch)``;
    ``natgrad_lr`` is a float or a host schedule ``f(step) -> float``.
    Returns the loss at the parameters before each update.
    """
    from .inference.natgrad import natgrad_step

    named = leaves_with_paths(params)
    leaves, p = _trainable(params)
    prefix = f"{natgrad_block}/"
    in_block = [natgrad_block is not None and (path == natgrad_block or path.startswith(prefix))
                for path, _ in named]
    block_leaves = [x for x, b in zip(leaves, in_block) if b]
    data_leaves = [x for _, x in leaves_with_paths(data)]
    indices = batch_indices(data_leaves[0], iters, batch_size, generator=generator, seed=seed,
                            indices=indices)
    ng_loss = natgrad_loss if natgrad_loss is not None else (lambda q, b: -loss_fn(q, b))
    opt = OptaxAdam(leaves, learning_rate, clip_norm)
    losses = None
    aux = None
    for i in range(iters):
        if aux_fn is not None and i % aux_every == 0:
            with torch.no_grad():
                aux = aux_fn(p)
        idx = indices[i]
        batch = with_leaves(data, [a[idx] for a in data_leaves])
        loss = loss_fn(p, batch) if aux_fn is None else loss_fn(p, batch, aux)
        grads = _grads(loss, leaves, in_block)
        losses = _losses_for(losses, iters, loss)
        losses[i] = loss.detach()
        opt.step(grads, i)
        if natgrad_block is not None:
            lr_i = natgrad_lr(i) if callable(natgrad_lr) else natgrad_lr
            base = with_leaves(params, [x.detach() for x in leaves])
            blk = natgrad_step(lambda q: ng_loss({**base, natgrad_block: q}, batch),
                               base[natgrad_block], lr_i)
            with torch.no_grad():
                for x, (_, new) in zip(block_leaves, leaves_with_paths(blk)):
                    x.copy_(new)
    if losses is None:
        losses = torch.empty(0, dtype=leaves[0].dtype, device=leaves[0].device)
    return FitResult(params=with_leaves(params, [x.detach() for x in leaves]), losses=losses)


def _value_and_grad(loss_fn, unravel):
    def vg(v):
        v = v.detach().requires_grad_(True)
        f = loss_fn(unravel(v))
        (g,) = torch.autograd.grad(f, v)
        return f.detach(), g

    return vg


def fit_scg(
    loss_fn: Callable,
    params,
    *,
    iters: int,
    sigma0: float = 1e-4,
    lam0: float = 1e-6,
) -> FitResult:
    """Scaled conjugate gradients (Moller 1993), the reference's second
    optimizer, on the flat vector of :func:`ravel`: a fixed number of
    steps, two value-and-grad evaluations each, no line search. A step that
    fails the trust test leaves the iterate unchanged and raises the damping
    ``lam``; every branch is a ``torch.where`` on device tensors, so the loop
    never waits for the card and the loss trajectory is monotone
    non-increasing. Returns the loss after each step."""
    flat0, unravel = ravel(params)
    vg = _value_and_grad(loss_fn, unravel)
    n = flat0.shape[0]
    dt, dev = flat0.dtype, flat0.device
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)
    lam_min, lam_max = 1e-15, 1e20

    w = flat0.detach()
    f, g = vg(w)
    d = -g
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    nsucc = torch.zeros((), dtype=torch.int64, device=dev)
    losses = torch.empty(iters, dtype=f.dtype, device=dev)
    for i in range(iters):
        kappa = torch.maximum(torch.dot(d, d), tiny)
        sigma = sigma0 / torch.sqrt(kappa)
        _, g_plus = vg(w + sigma * d)
        theta = torch.dot(d, g_plus - g) / sigma
        delta = theta + lam * kappa
        # indefinite curvature: shift lam so that delta = lam * kappa > 0
        indefinite = delta <= 0
        lam = torch.where(indefinite, lam - theta / kappa, lam)
        delta = torch.where(indefinite, lam * kappa, delta)
        mu = torch.dot(d, g)
        alpha = -mu / torch.maximum(delta, tiny)
        w_new = w + alpha * d
        f_new, g_new = vg(w_new)
        # comparison ratio: actual against predicted decrease
        am = alpha * mu
        Delta = 2.0 * (f_new - f) / torch.where(am == 0, tiny, am)
        ok = (Delta >= 0) & torch.isfinite(f_new)
        w = torch.where(ok, w_new, w)
        f = torch.where(ok, f_new, f)
        g_next = torch.where(ok, g_new, g)
        # direction: restart every n successes, else Polak-Ribiere-like
        nsucc = torch.where(ok, nsucc + 1, nsucc)
        restart = ok & (nsucc % n == 0)
        gamma = torch.dot(g - g_new, g_new) / torch.where(mu == 0, tiny, mu)
        d = torch.where(ok, torch.where(restart, -g_next, gamma * d - g_next), d)
        g = g_next
        lam = torch.where(Delta < 0.25, torch.clamp(4.0 * lam, max=lam_max), lam)
        lam = torch.where(Delta > 0.75, torch.clamp(0.5 * lam, min=lam_min), lam)
        losses[i] = f
    return FitResult(params=unravel(w), losses=losses)


def fit_scipy_lbfgs(
    loss_fn: Callable,
    params,
    *,
    max_iters: int = 1000,
    verbose: bool = False,
) -> FitResult:
    """scipy L-BFGS-B on the flat vector of :func:`ravel` (reference parity):
    a host loop over a float64 vector, each value and gradient evaluated on
    the parameters' device and dtype. Returns every evaluated loss."""
    import scipy.optimize

    flat0, unravel = ravel(params)
    vg = _value_and_grad(loss_fn, unravel)
    dt, dev = flat0.dtype, flat0.device
    trace = []

    def f_fp(v):
        val, g = vg(torch.as_tensor(v, dtype=dt, device=dev))
        trace.append(float(val))
        return float(val), g.double().cpu().numpy()

    res = scipy.optimize.minimize(
        f_fp, flat0.detach().double().cpu().numpy(), jac=True, method="L-BFGS-B",
        options={"maxiter": max_iters, **({"disp": True} if verbose else {})},
    )
    return FitResult(params=unravel(torch.as_tensor(res.x, dtype=dt, device=dev)),
                     losses=torch.tensor(np.asarray(trace), dtype=dt, device=dev))
