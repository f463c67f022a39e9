"""Covariance functions (port of ``rgp_tpu/kernels/__init__.py``, RBF only).

Kernels are frozen dataclasses describing structure (input dim, ARD flag,
active dims); hyperparameters live in a separate dict of unconstrained tensors
made by :meth:`Kernel.init`. The JAX package's other kernels (Linear, White,
Bias, Sum, Prod, Exponential, Matern32/52, RatQuad, StdPeriodic, MLP) are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .linalg import hdot
from .params import np_positive_inv, positive

__all__ = [
    "Kernel",
    "RBF",
    "Linear",
    "White",
    "Bias",
    "Sum",
    "Prod",
    "Exponential",
    "Matern32",
    "Matern52",
    "RatQuad",
    "StdPeriodic",
    "MLP",
    "kern_slice",
]


def kern_slice(kern: "Kernel", X):
    """Apply a kernel's active_dims restriction to an input matrix."""
    if kern.active_dims is None:
        return X
    return X[..., list(kern.active_dims)]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Base: structural description of a covariance function."""

    input_dim: int
    active_dims: Optional[Tuple[int, ...]] = None

    def init(self, **kw):
        raise NotImplementedError

    def K(self, p, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, p, X):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """RBF / squared-exponential with optional ARD lengthscales.

    k(x,x') = s_f^2 exp(-1/2 sum_q (x_q-x'_q)^2 / l_q^2)
    """

    ard: bool = True

    def init(self, variance: float = 1.0, lengthscale=1.0, dtype=torch.float32,
             device=None):
        nls = self.input_dim if self.ard else 1
        ls = np.broadcast_to(np.asarray(lengthscale, np.float64), (nls,))
        return {
            "log_var": np_positive_inv(variance, dtype, device),
            "log_ls": np_positive_inv(ls, dtype, device),
        }

    def _scaled(self, p, X):
        ls = positive(p["log_ls"])
        return kern_slice(self, X) / ls

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        Xs = self._scaled(p, X)
        X2s = Xs if X2 is None else self._scaled(p, X2)
        return var * torch.exp(-0.5 * self._sqdist(Xs, X2s))

    @staticmethod
    def _sqdist(A, B):
        # ||a||^2 + ||b||^2 - 2 a.b; clamp tiny negatives from rounding
        aa = (A * A).sum(-1)[..., :, None]
        bb = (B * B).sum(-1)[..., None, :]
        ab = hdot(A, B.mT)
        return torch.clamp(aa + bb - 2.0 * ab, min=0.0)

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


def _not_ported(name):
    def __init__(self, *args, **kw):
        raise NotImplementedError(
            f"kernel {name} is not ported to rgp_tpu_torch yet (ROADMAP.md Queue 1)"
        )

    return type(name, (Kernel,), {"__init__": __init__})


Linear = _not_ported("Linear")
White = _not_ported("White")
Bias = _not_ported("Bias")
Sum = _not_ported("Sum")
Prod = _not_ported("Prod")
Exponential = _not_ported("Exponential")
Matern32 = _not_ported("Matern32")
Matern52 = _not_ported("Matern52")
RatQuad = _not_ported("RatQuad")
StdPeriodic = _not_ported("StdPeriodic")
MLP = _not_ported("MLP")
