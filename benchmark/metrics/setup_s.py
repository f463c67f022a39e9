"""Seconds from the process's start to the window's first timed step:
imports, the kernel build (a first run in a checkout) or its cache, the
record, the parameters and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
