"""Finite-difference gradient checking (port of ``rgp_tpu/utils/checkgrad.py``).

The reborn ``Model.checkgrad()``: central differences on the flat
unconstrained vector (:func:`rgp_tpu_torch.params.ravel`) against autograd,
per coordinate, in float64, with a relative-error report.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..params import ravel

__all__ = ["checkgrad", "CheckgradResult"]


class CheckgradResult(NamedTuple):
    max_abs_err: float
    max_rel_err: float
    analytic: np.ndarray
    numeric: np.ndarray

    @property
    def ok(self):
        """Finite analytic gradient AND FD agreement within 1e-4 relative."""
        return bool(np.isfinite(self.analytic).all()) and self.max_rel_err < 1e-4

    def passed(self, rel_tol: float = 1e-4) -> bool:
        return bool(np.isfinite(self.analytic).all()) and self.max_rel_err < rel_tol


def checkgrad(f: Callable, params, eps: float = 1e-5, *, max_coords: int | None = None,
              seed: int = 0) -> CheckgradResult:
    """Compare autograd of ``f`` (a param tree -> a scalar) with central
    differences at ``params``, in float64 on the parameters' device. With
    ``max_coords``, a random subset of that many coordinates (numpy
    ``default_rng(seed)``) is checked."""
    flat, unravel = ravel(params)
    flat = flat.detach().double()

    def f_flat(v):
        return f(unravel(v))

    v = flat.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f_flat(v), v)
    analytic = g.cpu().numpy()

    n = flat.numel()
    idx = np.arange(n)
    if max_coords is not None and n > max_coords:
        idx = np.random.default_rng(seed).choice(n, size=max_coords, replace=False)

    numeric = np.full(n, np.nan)
    with torch.no_grad():
        for i in idx:
            e = torch.zeros_like(flat)
            e[i] = eps
            numeric[i] = (float(f_flat(flat + e)) - float(f_flat(flat - e))) / (2.0 * eps)

    abs_err = np.abs(analytic[idx] - numeric[idx])
    denom = np.maximum(np.abs(analytic[idx]) + np.abs(numeric[idx]), 1e-10)
    rel_err = 2.0 * abs_err / denom
    return CheckgradResult(float(abs_err.max()), float(rel_err.max()), analytic, numeric)
