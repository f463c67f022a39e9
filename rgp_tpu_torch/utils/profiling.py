"""Profiling helpers (port of ``rgp_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a code region, exported as a Chrome trace, and
named regions (``record_function``) that attribute the time of the hot ops
(Psi statistics, Cholesky, solves) in that trace."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (CPU, and CUDA where a card is present) and write
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing). Yields
    the profiler, whose ``key_averages()`` sums the region's ops by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region of the profile, for attributing a block of code."""
    return record_function(name)
