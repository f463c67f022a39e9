"""Profiling helpers (port of ``rgp_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a code region, exported as a Chrome trace, and
named regions (``record_function``) that attribute the time of the hot ops
in that trace. The serving path records six: ``rgp.posteriors`` and
``rgp.freerun.step`` (``models/rgp.freerun``), ``psi.stats``
(``ops/psi_stats.psi_statistics``), ``psi.per_t``
(``inference/collapsed_vi.predict_uncertain``), inside either of these
``psi.cross`` (each pair's cross term of an additive kernel,
``ops/psi_stats._sum_psi2_cross``) and, around each replay of a
captured graph of a batched freerun's steps, ``rgp.freerun.replay``
(``models/rgp.StepGraphs``), inside the step's and Psi terms' regions."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]

_OFF = contextlib.nullcontext()


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
    """A named region of the profile, for attributing a block of code. With
    no profiler running it returns a shared null context and records
    nothing, so a region on the hot path costs one check."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(name)
