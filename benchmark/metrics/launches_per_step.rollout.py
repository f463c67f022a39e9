"""Device operations in the traced requests over their freerun steps, the
requests' posteriors included (device trace)."""


def read(ctx):
    if ctx.kind != "rollout" or ctx.trace is None or not ctx.units or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.units
