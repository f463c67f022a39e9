"""Device operations launched inside an ``rgp.freerun.step`` span, over the
traced freerun steps: a closed-loop step's launches, the posteriors left
out (device trace)."""

from benchmark import spans


def read(ctx):
    r = spans.of(ctx)
    if r is None or not ctx.units or not r.nesting.named(spans.STEP):
        return None
    return sum(spans.STEP in r.holding(t) for _, _, _, t in r.ops) / ctx.units
