"""``descent.collect_ms``: the device's busy time spent on the collect rung
(``ksel.collect``: the match counts, the candidates' gather, the pick), in
milliseconds a query: the union of the device ops' intervals inside the
collect's device ranges (``kbench/spans.py:collect_ranges``: those of
``ksel.collect``, of its steps and of the ``ksel.launch`` spans inside
them), over the queries. All on the device's clock; an op whose record the
profiler dropped is missing from the reading and nothing else is. A
program that emits no ``ksel.`` span reads nothing, and neither does a
trace with no device ranges; a window with no collect reads 0.
"""

from __future__ import annotations

from kbench import spans as sp
from kbench import trace


def read(view):
    spans = sp.in_window(view)
    if not spans or view.queries <= 0 or not sp.queries(spans):
        return None
    if not any(e.name == sp.COLLECT for e in spans):
        return 0.0
    ranges = sp.device_ranges(view)
    if not ranges:
        return None
    picked = trace.merge((e.ts, e.end) for e in sp.collect_ranges(ranges))
    return sp.covered(picked, sp.busy(view)) / 1e3 / view.queries
