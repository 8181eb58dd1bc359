"""``descent.hist_launches``: launches of the descent's histogram kernels
(rows 1 and 3: ``radix_histogram_kernel``, ``radix_histogram_multi_kernel``)
in the traced window, a query; counted in the trace and held against the
port's launch books."""

from __future__ import annotations

KERNELS = (r"\bradix_histogram_kernel\b", r"\bradix_histogram_multi_kernel\b")
BOOKS = ("radix_histogram32", "radix_histogram64", "radix_histogram_multi32", "radix_histogram_multi64")


def read(view):
    n, _ = view.group(KERNELS, BOOKS)
    return n / view.queries if n and view.queries else None
