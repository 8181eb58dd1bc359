"""``dispatch.host_us``: the host's own time a query inside the port's entry
points, in microseconds: the sum over the outermost entry spans
(``ksel.kselect``, ``ksel.kselect_many``, ``ksel.quantiles``, ``ksel.topk``)
of each span's length less the union of the ``ksel.descent.host_read``
spans inside it (where the host waits for the device), over the queries.

The reading includes what the profiler spends on the spans it reads: each
``ksel.*`` range nested in an entry span costs the host some microseconds
while the profiler records, so the metric moves when a span is added or
taken away, not only when the port's host path changes. Compare it only
between trees that emit the same spans. A program that emits none reads
nothing.
"""

from __future__ import annotations

from kbench import spans as sp
from kbench import trace


def read(view):
    spans = sp.in_window(view)
    entries = sp.queries(spans)
    if not entries or view.queries <= 0:
        return None
    reads = trace.merge((e.ts, e.end) for e in spans if e.name == sp.HOST_READ)
    total = 0.0
    for e in entries:
        waited = sum(min(b, e.end) - max(a, e.ts) for a, b in reads if a < e.end and b > e.ts)
        total += e.dur - waited
    return total / view.queries
