"""Parameter transforms and tree packing (port of ``rgp_tpu/params.py``).

Parameters are plain nested dicts (and lists) of *unconstrained* tensors;
positivity is applied at use sites with :func:`softplus` (the reference's
``Logexp``). Leaves are named by '/'-joined key paths (``"layers/0/Z"``) and
ordered as ``jax.tree_util`` orders them: dict keys sorted, lists in order.
:func:`ravel` packs them into the one flat vector that SCG, L-BFGS and
checkgrad work on (paramz's ``optimizer_array``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["softplus", "softplus_inv", "np_positive_inv", "positive", "positive_inv", "ravel",
           "log_jacobian_softplus", "leaves_with_paths", "with_leaves"]


def softplus(x):
    """ln(1 + e^x) as ``logaddexp(x, 0)``.

    Not ``F.softplus``: its linear branch above ``threshold=20`` changes values
    and gradients at the 1e-8 level against the JAX reference.
    """
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inv(y):
    """Inverse of :func:`softplus`: x = y + log(1 - e^{-y}), stable for y > 0."""
    return y + torch.log(-torch.expm1(-y))


def np_positive_inv(y, dtype, device=None):
    """Host-side (numpy f64) softplus inverse for initialization code, so the
    port's init rounds exactly as the JAX package's does. ``device=None``
    means the card (:func:`rgp_tpu_torch.device.resolve_device`)."""
    y = np.asarray(y, np.float64)
    x = y + np.log(-np.expm1(-y))
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


positive = softplus
positive_inv = softplus_inv


def log_jacobian_softplus(x):
    """log |d softplus(x) / dx| = log sigmoid(x), summed over all elements."""
    return torch.nn.functional.logsigmoid(x).sum()


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


def ravel(tree):
    """``(flat, unravel)``: the leaves flattened and concatenated in
    :func:`leaves_with_paths` order (``jax.flatten_util.ravel_pytree``'s), and
    the function that cuts a vector of that length back into ``tree``'s
    nesting and shapes. ``unravel`` returns views of its argument, so
    gradients flow through it."""
    leaves = [x for _, x in leaves_with_paths(tree)]
    shapes = [x.shape for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v):
        parts = torch.split(v, [s.numel() for s in shapes])
        return with_leaves(tree, [p.reshape(s) for p, s in zip(parts, shapes)])

    return flat, unravel
