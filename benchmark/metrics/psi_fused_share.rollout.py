"""The share of the traced ``psi.per_t`` spans (each layer's Psi terms in
each closed-loop step) that hold a device operation whose name contains
``psi2_contract``, the kernel K3 (``rgp_tpu_torch/csrc/psi2_contract.cu``),
which contracts a row's Psi2 with the predictive's matrices without forming
it (device trace). 0 where every layer forms its per-step Psi2; None where
the trace holds no such span."""

import bisect

from benchmark import spans

PER_T = "psi.per_t"
KERNEL = "psi2_contract"


def read(ctx):
    r = spans.of(ctx)
    per_t = sorted(r.nesting.named(PER_T)) if r is not None else []
    if not per_t:
        return None
    starts = [s for s, _ in per_t]
    held = set()
    for name, _, _, t in r.ops:
        if KERNEL in name and t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= per_t[i][1]:
                held.add(i)
    return 100.0 * len(held) / len(per_t)
