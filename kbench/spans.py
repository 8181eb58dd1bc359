"""The port's spans in a traced window, for the readers that take them.

The port marks its entry points, descent passes, host reads, collect and
kernel launches with ``record_function`` ranges named ``ksel.*``
(``utils/profiling.py:span`` in the port). They reach the exported trace
as ``user_annotation`` events on the host's clock. A program that emits
none (an older tree) gives an empty list here, and its readers read
nothing.

On the card the profiler also gives each span a device range
(``gpu_user_annotation``): from the start of the first device op launched
while the span was the innermost one open to the end of the last, on the
device's clock. The profiler ties each op to its span through the launch's
correlation id, so a range needs no comparison of the host's clock with
the device's (their conversion can leave a kernel a millisecond before its
own launch), and a device record the profiler drops takes its op out of a
range and nothing else. The readers of device time read these ranges.
"""

from __future__ import annotations

import bisect

from kbench import trace

PREFIX = "ksel."
ENTRIES = ("ksel.kselect", "ksel.kselect_many", "ksel.quantiles", "ksel.topk")
HOST_READ = "ksel.descent.host_read"
COLLECT = "ksel.collect"
COLLECT_STEPS = (COLLECT, "ksel.collect.match", "ksel.collect.gather", "ksel.collect.pick")
LAUNCH = "ksel.launch"
EPS_US = 0.01  # the rounding between a range's ends and its ops' (about 1 ns)


def in_window(view) -> list:
    """The ``ksel.*`` spans that start inside the traced window."""
    return [e for e in view.events
            if e.cat == "user_annotation" and e.name.startswith(PREFIX) and view.t0 <= e.ts < view.t1]


def queries(spans) -> list:
    """The outermost entry spans, in order: one a query of a closed loop
    (an entry point that another calls, as ``quantiles`` calls
    ``kselect_many``, lies inside the caller's span and is left out)."""
    out, outer_end = [], float("-inf")
    for e in sorted((e for e in spans if e.name in ENTRIES), key=lambda e: (e.ts, -e.dur)):
        if e.end > outer_end:
            out.append(e)
            outer_end = e.end
    return out


def device_ranges(view) -> list:
    """The device ranges of the trace's ``ksel.*`` spans in device order,
    less the entry spans' (an entry's range reaches from the query's first
    op it launched to its last, over every nested span's ops). The trace
    holds the window alone, so nothing on the device's clock is held
    against the window's bounds, which are the host's."""
    return sorted((e for e in view.events if e.cat == "gpu_user_annotation" and e.name.startswith(PREFIX)
                   and e.name not in ENTRIES), key=lambda e: e.ts)


def busy(view) -> list[tuple[float, float]]:
    """The device's busy stretches over the whole trace (merged, sorted)."""
    return trace.merge((e.ts, e.end) for e in view.events if e.cat in trace.DEVICE_CATS)


def collect_ranges(ranges) -> list:
    """The ranges of the collect's device ops. The profiler gives a device
    op to the innermost span open at its launch only, so the collect's ops
    lie in the ranges of ``ksel.collect`` and its steps and in those of the
    ``ksel.launch`` spans inside them. The port runs on one stream, so the
    collect is one stretch of ranges in device order: a launch's range is
    the collect's where the next range that is not a launch's is a collect
    step's (a descent pass's launch is followed by its pass, its host read
    or the next collect's launch and steps, never by a step of its own)."""
    out, i = [], 0
    while i < len(ranges):
        j = i
        while j < len(ranges) and ranges[j].name == LAUNCH:
            j += 1
        if j < len(ranges) and ranges[j].name in COLLECT_STEPS:
            out.extend(ranges[i:j + 1])
        i = j + 1
    return out


def covered(intervals, busy) -> float:
    """The length of ``busy`` (merged, sorted) inside ``intervals``
    (merged, sorted)."""
    total, j = 0.0, 0
    for s, e in intervals:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total += min(busy[k][1], e) - max(busy[k][0], s)
            k += 1
    return total


def idle_after(busy, starts, t) -> float:
    """The device-idle gap that starts where the busy stretch holding ``t``
    ends (0 where the device runs on past ``t``, or nothing follows);
    ``starts`` are the stretches' starts."""
    k = bisect.bisect_right(starts, t + EPS_US) - 1
    if k < 0 or k + 1 >= len(busy) or busy[k][1] > t + EPS_US:
        return 0.0
    return busy[k + 1][0] - busy[k][1]
