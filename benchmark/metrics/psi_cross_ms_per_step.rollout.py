"""Device time of the operations launched inside ``psi.cross`` spans (the
cross terms of an additive kernel's Psi2, in the posteriors' ``psi.stats``
and in each closed-loop step's ``psi.per_t``), over the traced freerun
steps (device trace). None where the trace holds no such span."""

from benchmark import spans

CROSS = "psi.cross"


def read(ctx):
    r = spans.of(ctx)
    if r is None or not ctx.units or not r.nesting.named(CROSS):
        return None
    ns = sum(d for _, _, d, t in r.ops if CROSS in r.holding(t))
    return ns / 1e6 / ctx.units
