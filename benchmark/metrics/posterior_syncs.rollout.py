"""Host waits on the device (CUDA runtime calls that synchronize a stream,
event or device, and blocking ``cudaMemcpy``) that lie inside an
``rgp.posteriors`` span, per traced request (device trace)."""

from benchmark import spans


def read(ctx):
    r = spans.of(ctx)
    if r is None or not r.nesting.named(spans.POSTERIORS) or not r.nesting.named(spans.REQUEST):
        return None
    inside = 0
    for _, s, e in r.waits:
        inside += any(n == spans.POSTERIORS and e <= pe for n, _, pe in r.nesting.around(s))
    return inside / len(r.nesting.named(spans.REQUEST))
