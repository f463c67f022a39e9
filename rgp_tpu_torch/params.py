"""Parameter transforms (port of ``rgp_tpu/params.py``).

Parameters are plain nested dicts of *unconstrained* tensors; positivity is
applied at use sites with :func:`softplus` (the reference's ``Logexp``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["softplus", "softplus_inv", "np_positive_inv", "positive", "positive_inv"]


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
