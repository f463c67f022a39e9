"""Covariance functions (port of ``rgp_tpu/kernels/__init__.py``).

Kernels are frozen dataclasses describing structure (input dim, ARD flag,
active dims); hyperparameters live in a separate dict of unconstrained tensors
made by :meth:`Kernel.init`, with positivity applied by softplus at use sites.
``Sum`` and ``Prod`` keep a tuple of part dicts, one per part, and are built
with ``k1 + k2`` and ``k1 * k2``. Gram matrices use the GEMM form
``||x||^2 + ||x'||^2 - 2 x.x'`` with TF32 off (see :mod:`.linalg`).
``init(device=None)`` puts the parameters on the card.
"""

from __future__ import annotations

import dataclasses
import math
import operator
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


# CPU scalars: a binary op takes them on any device as a kernel argument, so
# the clamps below allocate nothing on the card.
_ZERO = torch.zeros((), dtype=torch.float64)
_ONE = torch.ones((), dtype=torch.float64)


def _sqdist(A, B):
    """||a||^2 + ||b||^2 - 2 a.b, with tiny negatives from rounding clamped to
    0. ``torch.maximum`` splits the gradient at a tie as ``jnp.maximum`` does
    (``clamp`` would pass all of it)."""
    aa = (A * A).sum(-1)[..., :, None]
    bb = (B * B).sum(-1)[..., None, :]
    ab = hdot(A, B.mT)
    return torch.maximum(aa + bb - 2.0 * ab, _ZERO)


def _lengthscale_init(kern, variance, lengthscale, dtype, device):
    nls = kern.input_dim if kern.ard else 1
    ls = np.broadcast_to(np.asarray(lengthscale, np.float64), (nls,))
    return {
        "log_var": np_positive_inv(variance, dtype, device),
        "log_ls": np_positive_inv(ls, dtype, device),
    }


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

    def _dims_union(self, other: "Kernel") -> int:
        mine = self.active_dims if self.active_dims is not None else range(self.input_dim)
        theirs = other.active_dims if other.active_dims is not None else range(other.input_dim)
        return max(*mine, *theirs) + 1

    def __add__(self, other: "Kernel") -> "Sum":
        if not isinstance(other, Kernel):
            return NotImplemented
        a = self.parts if isinstance(self, Sum) else (self,)
        b = other.parts if isinstance(other, Sum) else (other,)
        return Sum(input_dim=self._dims_union(other), parts=a + b)

    def __mul__(self, other: "Kernel") -> "Prod":
        if not isinstance(other, Kernel):
            return NotImplemented
        a = self.parts if isinstance(self, Prod) else (self,)
        b = other.parts if isinstance(other, Prod) else (other,)
        return Prod(input_dim=self._dims_union(other), parts=a + b)


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """RBF / squared-exponential with optional ARD lengthscales.

    k(x,x') = s_f^2 exp(-1/2 sum_q (x_q-x'_q)^2 / l_q^2)
    """

    ard: bool = True

    def init(self, variance: float = 1.0, lengthscale=1.0, dtype=torch.float32,
             device=None):
        return _lengthscale_init(self, variance, lengthscale, dtype, device)

    def _scaled(self, p, X):
        ls = positive(p["log_ls"])
        return kern_slice(self, X) / ls

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        Xs = self._scaled(p, X)
        X2s = Xs if X2 is None else self._scaled(p, X2)
        return var * torch.exp(-0.5 * _sqdist(Xs, X2s))

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


def _safe_r(r2):
    """sqrt(r2) with a gradient-safe zero: the inner ``where`` keeps ``sqrt``
    off 0, so its infinite slope never meets the outer ``where``'s zero
    cotangent (0 * inf would be NaN on Kmm's diagonal)."""
    pos = r2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, r2, 1.0)), 0.0)


@dataclasses.dataclass(frozen=True)
class _StationaryIso(Kernel):
    """Base for stationary kernels of the scaled distance r: they share the
    lengthscale and variance plumbing and differ only in K(r)."""

    ard: bool = True

    def init(self, variance: float = 1.0, lengthscale=1.0, dtype=torch.float32,
             device=None):
        return _lengthscale_init(self, variance, lengthscale, dtype, device)

    def _r2(self, p, X, X2):
        ls = positive(p["log_ls"])
        A = kern_slice(self, X) / ls
        B = A if X2 is None else kern_slice(self, X2) / ls
        return _sqdist(A, B)

    def K_of_r(self, r):
        raise NotImplementedError

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        return var * self.K_of_r(_safe_r(self._r2(p, X, X2)))

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class Exponential(_StationaryIso):
    """k = s^2 exp(-r)  (Matern-1/2)."""

    def K_of_r(self, r):
        return torch.exp(-r)


@dataclasses.dataclass(frozen=True)
class Matern32(_StationaryIso):
    """k = s^2 (1 + sqrt(3) r) exp(-sqrt(3) r)."""

    def K_of_r(self, r):
        a = math.sqrt(3.0) * r
        return (1.0 + a) * torch.exp(-a)


@dataclasses.dataclass(frozen=True)
class Matern52(_StationaryIso):
    """k = s^2 (1 + sqrt(5) r + 5 r^2/3) exp(-sqrt(5) r)."""

    def K_of_r(self, r):
        a = math.sqrt(5.0) * r
        return (1.0 + a + a * a / 3.0) * torch.exp(-a)


@dataclasses.dataclass(frozen=True)
class RatQuad(_StationaryIso):
    """Rational quadratic k = s^2 (1 + r^2/(2 alpha))^(-alpha); alpha
    ("power") is a positive hyperparameter."""

    def init(self, variance: float = 1.0, lengthscale=1.0, power: float = 2.0,
             dtype=torch.float32, device=None):
        p = super().init(variance=variance, lengthscale=lengthscale, dtype=dtype, device=device)
        p["log_power"] = np_positive_inv(power, dtype, device)
        return p

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        alpha = positive(p["log_power"])
        r2 = self._r2(p, X, X2)
        return var * torch.exp(-alpha * torch.log1p(r2 / (2.0 * alpha)))


@dataclasses.dataclass(frozen=True)
class StdPeriodic(Kernel):
    """Standard periodic kernel (MacKay):
    k = s^2 exp(-2 sum_q sin^2(pi (x_q - x'_q)/T_q) / l_q^2)."""

    ard: bool = True

    def init(self, variance: float = 1.0, period=1.0, lengthscale=1.0, dtype=torch.float32,
             device=None):
        n = self.input_dim if self.ard else 1
        per = np.broadcast_to(np.asarray(period, np.float64), (n,))
        ls = np.broadcast_to(np.asarray(lengthscale, np.float64), (n,))
        return {
            "log_var": np_positive_inv(variance, dtype, device),
            "log_period": np_positive_inv(per, dtype, device),
            "log_ls": np_positive_inv(ls, dtype, device),
        }

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        per = positive(p["log_period"])
        ls = positive(p["log_ls"])
        Xa = kern_slice(self, X)
        X2a = Xa if X2 is None else kern_slice(self, X2)
        d = Xa[..., :, None, :] - X2a[..., None, :, :]  # (N, N2, Q)
        sin2 = torch.sin(math.pi * d / per) ** 2
        return var * torch.exp(-2.0 * (sin2 / (ls * ls)).sum(-1))

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class MLP(Kernel):
    """Arcsine / neural-network kernel (Williams 1998):
    k = s^2 (2/pi) asin( w x.x' + b ) / sqrt((w x.x + b + 1)(w x'.x' + b + 1));
    w = weight variance, b = bias variance."""

    def init(self, variance: float = 1.0, weight_variance: float = 1.0,
             bias_variance: float = 1.0, dtype=torch.float32, device=None):
        return {
            "log_var": np_positive_inv(variance, dtype, device),
            "log_w": np_positive_inv(weight_variance, dtype, device),
            "log_b": np_positive_inv(bias_variance, dtype, device),
        }

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        w = positive(p["log_w"])
        b = positive(p["log_b"])
        Xa = kern_slice(self, X)
        X2a = Xa if X2 is None else kern_slice(self, X2)
        num = w * hdot(Xa, X2a.mT) + b
        dx = w * (Xa * Xa).sum(-1) + b + 1.0
        dx2 = w * (X2a * X2a).sum(-1) + b + 1.0
        denom = torch.sqrt(dx[..., :, None] * dx2[..., None, :])
        # clip for f32 rounding: |num/denom| can exceed 1 by ~1e-7 on the
        # diagonal; maximum/minimum split a tie's gradient as jnp.clip does
        z = torch.minimum(torch.maximum(num / denom, -_ONE), _ONE)
        return var * (2.0 / math.pi) * torch.arcsin(z)

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        w = positive(p["log_w"])
        b = positive(p["log_b"])
        Xa = kern_slice(self, X)
        dx = w * (Xa * Xa).sum(-1) + b
        return var * (2.0 / math.pi) * torch.arcsin(dx / (dx + 1.0))


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """Linear kernel k(x,x') = sum_q v_q x_q x'_q."""

    ard: bool = True

    def init(self, variance: float = 1.0, dtype=torch.float32, device=None):
        nv = self.input_dim if self.ard else 1
        v = np.broadcast_to(np.asarray(variance, np.float64), (nv,))
        return {"log_var": np_positive_inv(v, dtype, device)}

    def K(self, p, X, X2=None):
        v = positive(p["log_var"])
        Xa = kern_slice(self, X)
        X2a = Xa if X2 is None else kern_slice(self, X2)
        return hdot(Xa * v, X2a.mT)

    def Kdiag(self, p, X):
        v = positive(p["log_var"])
        Xa = kern_slice(self, X)
        return (Xa * Xa * v).sum(-1)


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """White noise: k = s^2 I on matching inputs."""

    def init(self, variance: float = 1.0, dtype=torch.float32, device=None):
        return {"log_var": np_positive_inv(variance, dtype, device)}

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        n = X.shape[-2]
        if X2 is None:
            return var * torch.eye(n, dtype=X.dtype, device=X.device)
        return X.new_zeros(tuple(X.shape[:-2]) + (n, X2.shape[-2]))

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class Bias(Kernel):
    """Constant kernel k = s^2."""

    def init(self, variance: float = 1.0, dtype=torch.float32, device=None):
        return {"log_var": np_positive_inv(variance, dtype, device)}

    def K(self, p, X, X2=None):
        var = positive(p["log_var"])
        m = X.shape[-2] if X2 is None else X2.shape[-2]
        return var.expand(tuple(X.shape[:-2]) + (X.shape[-2], m))

    def Kdiag(self, p, X):
        var = positive(p["log_var"])
        return var.expand(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class _Combination(Kernel):
    """Sum or Prod of parts (``_combine`` is + or *); the parameters are a
    tuple of part dicts."""

    parts: Tuple[Kernel, ...] = ()

    def init(self, *part_kwargs, dtype=torch.float32, device=None):
        if not part_kwargs:
            part_kwargs = tuple({} for _ in self.parts)
        return tuple(k.init(dtype=dtype, device=device, **kw) for k, kw in zip(self.parts, part_kwargs))

    def K(self, p, X, X2=None):
        out = self.parts[0].K(p[0], X, X2)
        for k, pk in zip(self.parts[1:], p[1:]):
            out = self._combine(out, k.K(pk, X, X2))
        return out

    def Kdiag(self, p, X):
        out = self.parts[0].Kdiag(p[0], X)
        for k, pk in zip(self.parts[1:], p[1:]):
            out = self._combine(out, k.Kdiag(pk, X))
        return out


@dataclasses.dataclass(frozen=True)
class Prod(_Combination):
    """Multiplicative combination. Closed-form uncertain-input psi statistics
    exist only for parts on disjoint active dims (see
    :func:`rgp_tpu_torch.ops.psi_stats.has_closed_psi`)."""

    _combine = staticmethod(operator.mul)


@dataclasses.dataclass(frozen=True)
class Sum(_Combination):
    """Additive combination."""

    _combine = staticmethod(operator.add)
