"""NARX windowing and normalization (port of ``rgp_tpu/data/windows.py``).

Lag convention: ``lagged(X, L)[t] = [x_{t-1}, ..., x_{t-L}]`` flattened
feature-major (most recent lag first); ``current_window(X, L)[t] = [x_t, ...,
x_{t-L+1}]`` includes the current step. Rows before the start are zero-padded.
The ``np_*`` twins run on the host for initialization code.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["lagged", "current_window", "narx_design", "Standardizer", "np_lagged", "np_current_window",
           "np_narx_design"]


def _np_stack_lags(X, lags):
    X = np.asarray(X)
    T = X.shape[0]
    cols = []
    for k in lags:
        if k == 0:
            cols.append(X)
        else:
            pad = np.zeros((k,) + X.shape[1:], dtype=X.dtype)
            cols.append(np.concatenate([pad, X[: T - k]], axis=0))
    return np.concatenate(cols, axis=-1)


def np_lagged(X, L: int):
    """numpy twin of :func:`lagged`."""
    return _np_stack_lags(X, list(range(1, L + 1)))


def np_current_window(X, L: int):
    """numpy twin of :func:`current_window`."""
    return _np_stack_lags(X, list(range(0, L)))


def _narx(Y, U, y_win, u_win, lagged_fn, window_fn, cat):
    feats = []
    if y_win > 0:
        feats.append(lagged_fn(Y, y_win))
    if U is not None and u_win > 0:
        feats.append(window_fn(U, u_win))
    if not feats:
        raise ValueError("need y_win > 0 or (U, u_win > 0)")
    X = cat(feats)
    start = max(y_win, u_win - 1 if u_win > 0 else 0)
    return X[start:], Y[start:]


def np_narx_design(Y, U=None, y_win: int = 0, u_win: int = 0):
    """numpy twin of :func:`narx_design`."""
    return _narx(np.asarray(Y), None if U is None else np.asarray(U), y_win, u_win,
                 np_lagged, np_current_window, lambda f: np.concatenate(f, axis=-1))


def _stack_lags(X, lags):
    """X: (T, D); lags: nonneg ints k meaning x_{t-k}; rows with t-k < 0 are zero."""
    T = X.shape[0]
    cols = []
    for k in lags:
        if k == 0:
            cols.append(X)
        else:
            pad = X.new_zeros((k,) + tuple(X.shape[1:]))
            cols.append(torch.cat([pad, X[: T - k]], dim=0))
    return torch.cat(cols, dim=-1)


def lagged(X, L: int):
    """(T, D) -> (T, L*D): [x_{t-1}, ..., x_{t-L}]."""
    return _stack_lags(X, list(range(1, L + 1)))


def current_window(X, L: int):
    """(T, D) -> (T, L*D): [x_t, ..., x_{t-L+1}]."""
    return _stack_lags(X, list(range(0, L)))


def narx_design(Y, U=None, y_win: int = 0, u_win: int = 0):
    """A GP-NARX regression problem: targets y_t, inputs [y_{t-1..t-y_win},
    u_t..u_{t-u_win+1}], trimmed to valid rows. Returns (X_design, Y_targets)
    with T' = T - max(y_win, u_win-1) rows."""
    return _narx(Y, U, y_win, u_win, lagged, current_window, lambda f: torch.cat(f, dim=-1))


class Standardizer(NamedTuple):
    """Zero-mean/unit-variance scaling fit on the training split (numpy)."""

    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, X) -> "Standardizer":
        X = np.asarray(X)
        return cls(mean=X.mean(0), std=X.std(0) + 1e-12)

    def transform(self, X):
        return (np.asarray(X) - self.mean) / self.std

    def inverse(self, X):
        return np.asarray(X) * self.std + self.mean

    def inverse_var(self, V):
        return np.asarray(V) * self.std**2
