"""The program's own spans in a ``--trace 1`` run's profiler trace, and what
each holds: the device operations it launched, their device time, the host
waits on the device inside it and the device's idle time while it ran.

``rgp_tpu_torch`` names its regions with ``utils.profiling.annotate``
(``record_function``): ``rgp.posteriors`` (once a request),
``rgp.freerun.step`` (once a test step), ``psi.stats`` and ``psi.per_t``.
They are host events on kineto's clock, the clock of the device events.
A device operation belongs to the spans around the host call that launched
it (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...),
found by the correlation id kineto gives both; an operation whose launch is
not in the trace belongs to no span. Spans nest by interval. A program
without these spans reads as no spans, and the readers then return None.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

from .trace import _union

POSTERIORS, STEP, REQUEST = "rgp.posteriors", "rgp.freerun.step", "bench.request"
PSI = "psi."  # the prefix of psi.stats and psi.per_t


class Event(NamedTuple):
    kind: str  # "device" (an operation on the card), "launch" (a CUDA runtime or driver call) or "span"
    name: str
    start_ns: int
    end_ns: int
    corr: int  # kineto's correlation id (device operations and launches), else 0


class Nesting:
    """Spans ``[(name, start, end)]`` that nest by interval, as one thread's
    regions do; :meth:`around` gives those that hold an instant."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]
        self.parent, stack = [], []
        for i, (_, s, _e) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t):
        """The spans that hold instant ``t``, innermost first. Each of them
        holds the latest span to start by ``t``, so they are it and its
        ancestors."""
        out, i = [], bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.spans[i][2] >= t:
                out.append(self.spans[i])
            i = self.parent[i]
        return out

    def named(self, name):
        return [(s, e) for n, s, e in self.spans if n == name]


def is_wait(name):
    """A host call that waits for the device: a synchronize of a stream,
    event or device, or a blocking ``cudaMemcpy``."""
    return name.endswith("Synchronize") or name == "cudaMemcpy"


class Reading(NamedTuple):
    nesting: Nesting
    ops: list  # [(name, start_ns, duration_ns, launch_ns or None)], every device operation
    waits: list  # [(name, start_ns, end_ns)] host calls that wait for the device
    gaps: list  # [(start_ns, end_ns)] the device's idle gaps between operations

    def holding(self, t):
        """Names of the spans around instant ``t`` (none for None)."""
        return [] if t is None else [n for n, _, _ in self.nesting.around(t)]


def read(events) -> Reading:
    """The spans, device operations, waits and idle gaps of ``events``
    (:class:`Event`), each operation joined to its launch."""
    launches = {e.corr: e.start_ns for e in events if e.kind == "launch" and e.corr}
    ops = sorted(((e.name, e.start_ns, e.end_ns - e.start_ns, launches.get(e.corr))
                  for e in events if e.kind == "device"), key=lambda o: o[1])
    _, gaps = _union([(s, s + d) for _, s, d, _ in ops])
    waits = [(e.name, e.start_ns, e.end_ns) for e in events if e.kind == "launch" and is_wait(e.name)]
    return Reading(Nesting([(e.name, e.start_ns, e.end_ns) for e in events if e.kind == "span"]),
                   ops, waits, gaps)


def events_of(prof):
    """The :class:`Event` list of a stopped ``torch.profiler.profile``:
    device operations as ``trace.read`` counts them (CUDA events that are not
    user annotations), host calls into the CUDA runtime or driver, and host
    user annotations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                out.append(Event("device", name, s, s + e.duration_ns(), e.correlation_id()))
        elif e.is_user_annotation():
            out.append(Event("span", name, s, s + e.duration_ns(), 0))
        elif name.startswith("cu"):  # by name: not every torch's KinetoEvent has activity_type
            out.append(Event("launch", name, s, s + e.duration_ns(), e.correlation_id()))
    return out


def of(ctx) -> Optional[Reading]:
    """The reading of a rollout run's trace, made once and kept on ``ctx``
    for every reader of the run; None off a rollout or without a trace."""
    if ctx.kind != "rollout":
        return None
    if getattr(ctx, "span_reading", None) is None:
        win = getattr(ctx, "window", None)
        if win is None or win.trace is None or win.trace.prof is None:
            return None
        ctx.span_reading = read(events_of(win.trace.prof))
    return ctx.span_reading


def overlap_ns(a, b):
    """Length of the intersection of two lists of disjoint intervals, each
    sorted by start."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


PLACES = ("step", "posteriors", "request", "outside", "unjoined")


def place(r: Reading, t):
    """Where instant ``t`` (a launch, None if not in the trace) lies: in a
    step, in the posteriors, elsewhere in a request, outside every request,
    or "unjoined"."""
    if t is None:
        return "unjoined"
    names = r.holding(t)
    return ("step" if STEP in names else "posteriors" if POSTERIORS in names else "request" if REQUEST in names
            else "outside")


def attribution(r: Reading):
    """Device operations by :func:`place` of their launch; the counts sum to
    the number of device operations."""
    out = dict.fromkeys(PLACES, 0)
    for _, _, _, t in r.ops:
        out[place(r, t)] += 1
    return out
