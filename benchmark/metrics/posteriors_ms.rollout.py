"""Mean length of the traced requests' ``rgp.posteriors`` spans, the
program's posteriors with its waits on the device inside them (device
trace: the spans are on the profiler's clock)."""

from benchmark import spans


def read(ctx):
    r = spans.of(ctx)
    post = r.nesting.named(spans.POSTERIORS) if r is not None else []
    if not post:
        return None
    return sum(e - s for s, e in post) / len(post) / 1e6
