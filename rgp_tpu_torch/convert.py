"""Carry parameters over from the JAX package.

:func:`params_from_jax` takes any parameter pytree the JAX package makes (an
RGP's, with or without ``"encoder"``; a sparse GP's or GP-NARX's; any kernel's,
Sum and Prod parts as tuples), with its leaves already turned into numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), and returns the
same nesting of tensors with the same keys, so both packages compute the same
thing from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree, *, dtype, device=None):
    """Dicts, lists and tuples of numpy arrays -> the same nesting of tensors
    of ``dtype`` on ``device`` (``None`` means the card). Any other node, or a
    leaf that is not a numpy array or number, raises ``TypeError``."""
    dev = resolve_device(device)

    def convert(x, path):
        if isinstance(x, dict):
            return {k: convert(v, f"{path}/{k}") for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(convert(v, f"{path}/{i}") for i, v in enumerate(x))
        if isinstance(x, (np.ndarray, np.generic, float, int)) and not isinstance(x, bool):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        raise TypeError(f"params_from_jax: unsupported node {type(x).__name__} at '{path or '/'}'")

    return convert(tree, "")
