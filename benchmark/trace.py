"""Reading the profiler's trace of a window's stretch: the device operations
(kernels, copies, fills) with their times, the seconds the device was busy
(the union of their intervals), the device operations that took most time
and the idle gaps labelled by what the host was doing then."""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

class Trace(NamedTuple):
    ops: list  # [(name, start_ns, duration_ns)] device operations
    busy_s: float
    window_s: float
    top_ops: list  # [[name, seconds]] by total device time
    idle_gaps: list  # [[host activity, seconds]] idle device time by what the host ran


def _union(intervals):
    """(busy ns, [(gap start, gap end)]) of sorted (start, end) intervals."""
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def read(tracer, min_gap_ns=5000) -> Trace:
    events = tracer.prof.profiler.kineto_results.events()
    ops, host = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    ops.sort(key=lambda x: x[1])
    busy, gaps = _union([(s, s + d) for _, s, d in ops])
    by_name = {}
    for n, _, d in ops:
        by_name[n] = by_name.get(n, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for a, b in gaps:
        if b - a < min_gap_ns:
            continue
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid) - 1
        label, best = "(between host ops)", None
        # the innermost host op around the gap's middle: the latest started
        # that still runs then; ops nest, so look back a little way
        for k in range(j, max(-1, j - 256), -1):
            s, e, n = host[k]
            if e >= mid and (best is None or e - s < best):
                label, best = n, e - s
                break
        idle[label] = idle.get(label, 0) + (b - a)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace(ops, busy / 1e9, tracer.seconds, [[n, v / 1e9] for n, v in top],
                 [[n, v / 1e9] for n, v in gaps_top])
