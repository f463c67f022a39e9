"""The share of the traced ``rgp.freerun.step`` spans that hold an
``rgp.freerun.replay`` span: the closed-loop steps the program replayed
from captured CUDA graphs (device trace; 0 where every step ran eagerly)."""

import bisect

from benchmark import spans

REPLAY = "rgp.freerun.replay"


def read(ctx):
    r = spans.of(ctx)
    steps = r.nesting.named(spans.STEP) if r is not None else []
    if not steps:
        return None
    starts = sorted(s for s, _ in r.nesting.named(REPLAY))
    held = sum(bisect.bisect_left(starts, s) < bisect.bisect_right(starts, e) for s, e in steps)
    return 100.0 * held / len(steps)
