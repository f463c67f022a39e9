"""Inducing-point initialization (numpy copy of
``rgp_tpu.models.sparse_gp.kmeans_init``; the rest of that module is not
ported yet)."""

from __future__ import annotations

import numpy as np

__all__ = ["kmeans_init"]


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
