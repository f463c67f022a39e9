"""Config-5 posterior checks (the two pieces of
``rgp_tpu/bench/posterior_check.py`` that the sampling benchmark and the
chip check use): the capped per-dimension init jitter of the
Hessian-preconditioned chains (``_jit_scale``, shared with
``sample.api.sample_nuts``), and the moment comparison of two sets of draws
of one potential (``mode_compare``'s statistics).
"""

from __future__ import annotations

import numpy as np

from ..sample.api import _jit_scale
from ..sample.diagnostics import ess, split_rhat

__all__ = ["_jit_scale", "compare_draws"]


def compare_draws(d_t, div_t, d_c, div_c) -> dict:
    """Per-dimension moment deltas of draws ``d_t`` (chains, draws, dim)
    against reference draws ``d_c`` of the same potential, in combined
    Monte-Carlo-error units |mean_t - mean_c| / sqrt(se_t^2 + se_c^2) (se from
    the per-dim bulk ESS), std ratios, and split-R-hat / ESS of both;
    ``div_*`` are the (chains, draws) divergence flags. Dimensions where the
    reference has not mixed (ESS < 20 or R-hat > 1.2) cannot arbitrate a
    discrepancy and are also reported apart. The statistics of the JAX
    package's ``mode_compare``, with ``draws``/``reference`` for its
    ``tpu``/``cpu_ref``."""

    def _stats(d):
        flat = d.reshape(-1, d.shape[-1])
        e = np.atleast_1d(ess(d))
        se = flat.std(axis=0, ddof=1) / np.sqrt(np.maximum(e, 1.0))
        return flat.mean(axis=0), flat.std(axis=0, ddof=1), e, se

    m_t, s_t, e_t, se_t = _stats(d_t)
    m_c, s_c, e_c, se_c = _stats(d_c)
    z_scores = np.abs(m_t - m_c) / np.sqrt(se_t**2 + se_c**2)
    std_ratio = s_t / np.maximum(s_c, 1e-30)
    r_t = np.atleast_1d(split_rhat(d_t))
    r_c = np.atleast_1d(split_rhat(d_c))
    ok = (e_c >= 20.0) & (r_c <= 1.2)
    well = {
        "n_dims": int(ok.sum()),
        "moment_z_max": float(np.nanmax(z_scores[ok])) if ok.any() else None,
        "moment_z_median": float(np.nanmedian(z_scores[ok])) if ok.any() else None,
        "n_z_above_3": int(np.sum(z_scores[ok] > 3.0)) if ok.any() else None,
        "std_ratio_range": [float(std_ratio[ok].min()), float(std_ratio[ok].max())] if ok.any() else None,
    }
    return {
        "well_mixed_reference_dims": well,
        "dim": int(d_t.shape[-1]),
        "draws": {"chains": int(d_t.shape[0]), "draws": int(d_t.shape[1]),
                  "divergence_rate": float(div_t.mean()), "max_rhat": float(np.nanmax(r_t)),
                  "min_ess": float(np.nanmin(e_t)), "median_ess": float(np.nanmedian(e_t))},
        "reference": {"chains": int(d_c.shape[0]), "draws": int(d_c.shape[1]),
                      "divergence_rate": float(div_c.mean()), "max_rhat": float(np.nanmax(r_c)),
                      "min_ess": float(np.nanmin(e_c))},
        "moment_z_max": float(np.nanmax(z_scores)),
        "moment_z_median": float(np.nanmedian(z_scores)),
        "n_dims_z_above_3": int(np.sum(z_scores > 3.0)),
        "std_ratio_range": [float(std_ratio.min()), float(std_ratio.max())],
    }

