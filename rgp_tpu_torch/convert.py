"""Carry parameters over from the JAX package.

:func:`params_from_jax` takes the JAX package's RGP parameter pytree, with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side), and returns the port's nested dict of tensors with the same
key names, so both packages compute the same thing from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax"]

_LAYER_KEYS = ("kern", "Z", "log_noise", "mu0", "log_lam0", "mu", "log_lam")
_OUT_KEYS = ("kern", "Z", "log_noise")
_KERN_KEYS = ("log_var", "log_ls")


def params_from_jax(tree, *, dtype, device=None):
    """``{"layers": (..), "out": {..}}`` of numpy arrays -> the same nesting of
    tensors of ``dtype`` on ``device`` (``None`` means the card)."""
    if "encoder" in tree:
        raise NotImplementedError("encoder (back-constraint) weights are not ported yet")
    dev = resolve_device(device)

    def leaf(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def layer(d, keys):
        missing = set(keys) - set(d)
        if missing:
            raise KeyError(f"parameter dict lacks {sorted(missing)}")
        out = {k: leaf(d[k]) for k in keys if k != "kern"}
        out["kern"] = {k: leaf(d["kern"][k]) for k in _KERN_KEYS}
        return out

    return {
        "layers": [layer(lp, _LAYER_KEYS) for lp in tree["layers"]],
        "out": layer(tree["out"], _OUT_KEYS),
    }
