"""The 90th percentile of the latencies of a traced run's window, by
nearest rank: the smallest latency that at least 90% of its requests do not
exceed (host clock). The requests traced after the window, which the
profiler slows, are not among them. A per-layer metric: its runs spread too
widely on the card's shared host for a bound."""

import math


def p90(values):
    xs = sorted(values)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def read(ctx):
    if ctx.kind != "rollout" or not ctx.window.latencies:
        return None
    return 1e3 * p90(ctx.window.latencies)
