"""``descent.read_bubble_us``: the device's idle time around the descent's
host reads, in microseconds a query. A ``ksel.descent.host_read`` span's
device range ends with the read's own copy; the host wakes once the copy
is done, so the device-idle gap that holds the span's end is the one that
starts there, up to the next device op. The mean gap over the reads'
ranges times the reads a query (``descent.host_reads``): a range the
profiler lost leaves out one sample and nothing else. All on the device's
clock (``kbench/spans.py``). A read that ends while the device runs on
costs no gap. A program that emits no ``ksel.`` span reads nothing, and
neither does a trace with no device ranges for its reads.
"""

from __future__ import annotations

from kbench import spans as sp


def read(view):
    spans = sp.in_window(view)
    if not spans or view.queries <= 0 or not sp.queries(spans):
        return None
    reads = sum(e.name == sp.HOST_READ for e in spans)
    if not reads:
        return 0.0
    ranges = [e for e in sp.device_ranges(view) if e.name == sp.HOST_READ]
    if not ranges:
        return None
    busy = sp.busy(view)
    starts = [s for s, _ in busy]
    gap = sum(sp.idle_after(busy, starts, r.end) for r in ranges) / len(ranges)
    return gap * reads / view.queries
