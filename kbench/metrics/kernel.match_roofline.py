"""``kernel.match_roofline``: the collect's match-count kernel (row 5)
against its bandwidth roofline: each launch reads every key once and writes
one int32 count a prefix for every 128-key row, over the device time a
launch. A select collects one prefix; a quantiles table one a rank."""

from __future__ import annotations

from kbench import gen, trace, work

KERNELS = (r"\bmatch_counts_kernel\b",)
BOOKS = ("match_counts32", "match_counts64")


def read(view):
    n, seconds = view.group(KERNELS, BOOKS)
    if not n:
        return None
    itemsize = gen.torch_dtype(view.config["dtype"]).itemsize
    prefixes = view.params.get("table", {}).get("count", 1)
    nbytes = n * work.match_launch_bytes(view.config["n"], itemsize, prefixes)
    return trace.checked_share(work.roofline_pct(nbytes, seconds, view.kind), "kernel.match_roofline")
