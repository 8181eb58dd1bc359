"""``kernel.hist_roofline``: the descent's histogram kernels (rows 1 and 3)
against their bandwidth roofline: each launch reads every key once, over
the device time a launch."""

from __future__ import annotations

from kbench import gen, trace, work

KERNELS = (r"\bradix_histogram_kernel\b", r"\bradix_histogram_multi_kernel\b")
BOOKS = ("radix_histogram32", "radix_histogram64", "radix_histogram_multi32", "radix_histogram_multi64")


def read(view):
    n, seconds = view.group(KERNELS, BOOKS)
    if not n:
        return None
    itemsize = gen.torch_dtype(view.config["dtype"]).itemsize
    nbytes = n * work.histogram_launch_bytes(view.config["n"], itemsize)
    return trace.checked_share(work.roofline_pct(nbytes, seconds, view.kind), "kernel.hist_roofline")
