"""Simulated sequence-steps a second: requests times width times horizon
over the whole window (host clock)."""


def read(ctx):
    if ctx.kind != "rollout" or ctx.window.seconds <= 0:
        return None
    return ctx.window.work / ctx.window.seconds
