"""``device.work_roofline``: the least bytes a query's answer needs, at the
device's peak bandwidth, over the device's busy time a query.

The bytes are the op kind's (a select reads each key once; a batched top-k
reads the batch and writes k values and positions a row), so the reading
holds whatever kernels implement the query. The port's own kernels are
counted first: the trace has to hold as many as its launch books recorded.
"""

from __future__ import annotations

from kbench import trace, work

PORT_KERNELS = (r"\bradix_histogram", r"\bmatch_counts", r"\btau_counts", r"\bbatched_topk",
                r"\bsweep_ingest")


def read(view):
    if not view.device or view.queries <= 0:
        return None
    view.group(PORT_KERNELS, list(view.books))
    return trace.checked_share(
        work.roofline_pct(view.least_bytes * view.queries, view.busy_s, view.kind), "device.work_roofline")
