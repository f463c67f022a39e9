"""Plotting helpers (port of ``rgp_tpu/utils/plotting.py``: the reference's
``m.plot()`` workflow rebuilt as small matplotlib functions). Arrays may be
numpy arrays or tensors on any device.

Design rules: one axis per figure; the predictive mean is a 2px line with a
95% credible band in the same hue (identity travels with the entity, not its
rank); observations are small neutral markers; grids are recessive. Colors are
parameters so callers can theme them — defaults are matplotlib's first two
category colors.

Import is lazy and headless-safe: matplotlib is only required when a function
is called, and callers in scripts should select the Agg backend themselves if
running without a display.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_gp", "plot_freerun"]


def _np(x):
    """A flat float64 numpy copy of an array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64).reshape(-1)


def _ax(ax):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    ax.grid(True, alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    return ax


def plot_gp(
    x,
    mean,
    var,
    *,
    X_data=None,
    Y_data=None,
    ax=None,
    color="C0",
    data_color="0.3",
    label="predictive mean",
    band_label="95% band",
):
    """1-D GP predictive plot: mean line + 95% band (+ optional data scatter).

    ``x`` (T,), ``mean``/``var`` (T,) or (T, 1). Returns the axis.
    """
    ax = _ax(ax)
    x = _np(x)
    m = _np(mean)
    sd = np.sqrt(_np(var))
    order = np.argsort(x)
    x, m, sd = x[order], m[order], sd[order]
    ax.fill_between(x, m - 1.96 * sd, m + 1.96 * sd, color=color, alpha=0.2,
                    linewidth=0, label=band_label)
    ax.plot(x, m, color=color, linewidth=2, label=label)
    if X_data is not None and Y_data is not None:
        ax.plot(_np(X_data), _np(Y_data),
                "o", color=data_color, markersize=3, alpha=0.7, label="data")
    ax.legend(frameon=False)
    return ax


def plot_freerun(
    y_true,
    mean,
    var,
    *,
    t=None,
    ax=None,
    color="C1",
    truth_color="0.25",
    title=None,
):
    """Closed-loop free-simulation plot: truth vs moment-matched prediction
    with its 95% band (the reference's headline figure, SURVEY.md S3.3).

    ``y_true``/``mean``/``var``: (T,) or (T, 1). Returns the axis.
    """
    ax = _ax(ax)
    y = _np(y_true)
    m = _np(mean)
    sd = np.sqrt(_np(var))
    tt = np.arange(len(m)) if t is None else _np(t)
    ax.fill_between(tt, m - 1.96 * sd, m + 1.96 * sd, color=color, alpha=0.2,
                    linewidth=0, label="95% band")
    ax.plot(tt, m, color=color, linewidth=2, label="free simulation")
    ax.plot(tt, y, color=truth_color, linewidth=1.2, label="truth")
    rmse = float(np.sqrt(np.mean((m - y) ** 2)))
    ax.set_xlabel("t")
    ax.set_title(title if title is not None else f"free-run RMSE {rmse:.4f}")
    ax.legend(frameon=False)
    return ax
