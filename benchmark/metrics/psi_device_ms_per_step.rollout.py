"""Device time of the operations launched inside ``psi.stats`` and
``psi.per_t`` spans (the Psi statistics of the posteriors and of each
closed-loop step), over the traced freerun steps (device trace)."""

from benchmark import spans


def read(ctx):
    r = spans.of(ctx)
    if r is None or not ctx.units or not any(n.startswith(spans.PSI) for n, _, _ in r.nesting.spans):
        return None
    ns = sum(d for _, _, d, t in r.ops if any(n.startswith(spans.PSI) for n in r.holding(t)))
    return ns / 1e6 / ctx.units
