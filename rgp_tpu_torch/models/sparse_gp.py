"""Sparse variational GP regression on certain inputs, Titsias' collapsed
bound (port of ``rgp_tpu/models/sparse_gp.py``).

The bound goes through the psi-statistics path with s = 0, which reduces to
the plain collapsed bound; the whitened Psi2 is assembled from its factor
Psi1 = K (``certain=True``). :func:`kmeans_init` runs in numpy on the host,
exactly as the JAX package's does, so inits are array-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..inference.collapsed_vi import (
    SparsePosterior,
    collapsed_bound,
    posterior,
    posterior_f_samples,
    predict_certain,
    predict_uncertain,
)
from ..kernels import Kernel
from ..ops.psi_stats import psi_statistics
from ..params import np_positive_inv

__all__ = ["SparseGPConfig", "kmeans_init", "init_params", "elbo", "predict", "posterior_samples_f"]


@dataclasses.dataclass(frozen=True)
class SparseGPConfig:
    kernel: Kernel
    num_inducing: int


def kmeans_init(X, k: int, seed: int = 0, iters: int = 10,
                max_points: int = 4096) -> np.ndarray:
    """Tiny host-side Lloyd's k-means for inducing-point init. K-means is
    preferred to a data subset: windowed autoregressive designs contain
    near-duplicate rows (piecewise-constant inputs), which make Kmm
    numerically singular in f32. Distances use the GEMM form
    ||x||^2 - 2 x.c + ||c||^2; inputs beyond ``max_points`` are uniformly
    subsampled first."""
    X = np.asarray(X, np.float64)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    if k >= n:
        return X + 1e-3 * rng.standard_normal(X.shape)
    if n > max_points:
        X = X[rng.permutation(n)[:max_points]]
        n = max_points
    C = X[rng.permutation(n)[:k]].copy()
    x2 = (X * X).sum(-1)[:, None]  # (n, 1)
    for _ in range(iters):
        d2 = x2 - 2.0 * (X @ C.T) + (C * C).sum(-1)[None, :]
        assign = d2.argmin(1)
        for j in range(k):
            mask = assign == j
            if mask.any():
                C[j] = X[mask].mean(0)
            else:  # re-seed empty cluster
                C[j] = X[rng.integers(n)] + 1e-3 * rng.standard_normal(X.shape[1])
    return C


def host(x) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def init_params(cfg: SparseGPConfig, X, noise: float = 0.1, seed: int = 0,
                dtype=torch.float32, device=None, **kern_kw):
    """Inducing inputs by k-means over the (windowed) inputs ``X``;
    ``device=None`` means the card."""
    dev = resolve_device(device)
    Z = kmeans_init(host(X), cfg.num_inducing, seed=seed)
    return {
        "kern": cfg.kernel.init(dtype=dtype, device=dev, **kern_kw),
        "Z": torch.as_tensor(Z, dtype=dtype, device=dev),
        "log_noise": np_positive_inv(noise, dtype, dev),
    }


def elbo(cfg: SparseGPConfig, params, X, Y, *, block=None):
    stats = psi_statistics(cfg.kernel, params["kern"], params["Z"], X, None, block=block)
    return collapsed_bound(
        cfg.kernel, params["kern"], params["Z"], params["log_noise"], stats, Y, certain=True,
    )


def _posterior(cfg: SparseGPConfig, params, X, Y) -> SparsePosterior:
    stats = psi_statistics(cfg.kernel, params["kern"], params["Z"], X, None, block=None)
    return posterior(
        cfg.kernel, params["kern"], params["Z"], params["log_noise"], stats, Y, certain=True,
    )


def predict(cfg: SparseGPConfig, params, X, Y, Xs, *, include_noise: bool = True,
            full_cov: bool = False):
    post = _posterior(cfg, params, X, Y)
    if full_cov:
        return predict_certain(
            cfg.kernel, params["kern"], params["Z"], params["log_noise"], post, Xs,
            full_cov=True, include_noise=include_noise,
        )
    return predict_uncertain(
        cfg.kernel, params["kern"], params["Z"], params["log_noise"], post, Xs, None,
        include_noise=include_noise,
    )


def posterior_samples_f(cfg: SparseGPConfig, params, X, Y, Xs, generator: torch.Generator, *,
                        n_samples: int = 10, include_noise: bool = False):
    """Joint posterior function samples at Xs, drawn from ``generator``.
    Returns (n_samples, T*, D)."""
    post = _posterior(cfg, params, X, Y)
    return posterior_f_samples(
        cfg.kernel, params["kern"], params["Z"], params["log_noise"], post, Xs, generator,
        n_samples=n_samples, include_noise=include_noise,
    )
