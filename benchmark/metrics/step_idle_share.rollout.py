"""Of the device's idle time in the traced stretch (the gaps between its
operations, as ``idle_share.rollout`` counts them), the share that falls
while the host runs an ``rgp.freerun.step`` span (device trace)."""

from benchmark import spans


def read(ctx):
    r = spans.of(ctx)
    steps = r.nesting.named(spans.STEP) if r is not None else []
    idle = sum(e - s for s, e in r.gaps) if r is not None else 0
    if not steps or idle <= 0:
        return None
    return 100.0 * spans.overlap_ns(r.gaps, steps) / idle
