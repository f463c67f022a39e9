"""MCMC convergence diagnostics: split-R-hat and effective sample size (the
port's own copy of ``rgp_tpu/sample/diagnostics.py``; host-side numpy).

Definitions follow Vehtari, Gelman, Simpson, Carpenter, Burkner (2021)
"Rank-normalization, folding, and localization: an improved R-hat": split
each chain in half, compute the classic potential-scale-reduction factor over
the 2*n_chains half-chains, and estimate ESS from chain autocorrelations
combined via Geyer's initial monotone positive sequence.

API: arrays are (n_chains, n_draws) per scalar quantity or
(n_chains, n_draws, dim) for vector parameters (diagnostics are per-dim).
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "ess", "summarize"]


def _split(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2) half-chains."""
    c, n = x.shape
    h = n // 2
    return np.concatenate([x[:, :h], x[:, n - h:]], axis=0)


def split_rhat(x: np.ndarray) -> np.ndarray:
    """Split-R-hat. ``x``: (chains, draws) or (chains, draws, dim);
    returns scalar or (dim,). Requires draws >= 4."""
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        x = x[..., None]
    out = np.empty(x.shape[-1])
    for d in range(x.shape[-1]):
        s = _split(x[:, :, d])
        m, n = s.shape
        chain_mean = s.mean(axis=1)
        chain_var = s.var(axis=1, ddof=1)
        B = n * chain_mean.var(ddof=1)
        W = chain_var.mean()
        var_plus = (n - 1) / n * W + B / n
        out[d] = np.sqrt(var_plus / W) if W > 0 else np.inf
    return out[0] if out.shape == (1,) else out


def _ess_one(s: np.ndarray) -> float:
    """ESS of (m half-chains, n draws) for one quantity (Geyer pairwise)."""
    m, n = s.shape
    if n < 4:
        return float("nan")
    chain_var = s.var(axis=1, ddof=1)
    W = chain_var.mean()
    B = n * s.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B / n
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float("nan")
    # mean autocovariance over chains via FFT
    centered = s - s.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(centered, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    acov = acov / n  # biased estimator (Geyer's choice)
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # combined rho_t, rho_0 ~ 1
    # Geyer: sum consecutive pairs while positive, enforce monotone decrease
    tau = 0.0
    prev_pair = np.inf
    t = 1
    pair0 = rho[0] + (rho[1] if n > 1 else 0.0)
    prev_pair = min(pair0, prev_pair)
    tau = prev_pair
    t = 2
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)  # initial monotone sequence
        tau += pair
        prev_pair = pair
        t += 2
    tau = max(2.0 * tau - 1.0, 1.0 / np.log10(max(n * m, 10)))
    return float(m * n / tau)


def ess(x: np.ndarray) -> np.ndarray:
    """Bulk ESS (on split half-chains). ``x``: (chains, draws[, dim])."""
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        x = x[..., None]
    out = np.array([_ess_one(_split(x[:, :, d])) for d in range(x.shape[-1])])
    return out[0] if out.shape == (1,) else out


def summarize(samples: np.ndarray) -> dict:
    """Per-dim moments + worst-case diagnostics for (chains, draws, dim)."""
    samples = np.asarray(samples, np.float64)
    flat = samples.reshape(-1, samples.shape[-1])
    r = np.atleast_1d(split_rhat(samples))
    e = np.atleast_1d(ess(samples))
    return {
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0, ddof=1),
        "rhat": r,
        "ess": e,
        "max_rhat": float(np.nanmax(r)),
        "min_ess": float(np.nanmin(e)),
    }
