"""The share of the traced requests' stretch that no device operation
covers (device trace)."""


def read(ctx):
    if ctx.kind != "rollout" or ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
