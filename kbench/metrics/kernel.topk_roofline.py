"""``kernel.topk_roofline``: the batched top-k kernel (row 7) against its
bandwidth roofline: each launch reads the batch once and writes k values and
int64 positions a row, over the device time a launch."""

from __future__ import annotations

from kbench import gen, trace, work

KERNELS = (r"\bbatched_topk_kernel\b",)
BOOKS = ("batched_topk32", "batched_topk16")


def read(view):
    n, seconds = view.group(KERNELS, BOOKS)
    if not n:
        return None
    c = view.config
    nbytes = n * work.topk_bytes(c["batch"], c["width"], view.params["k"], gen.torch_dtype(c["dtype"]).itemsize)
    return trace.checked_share(work.roofline_pct(nbytes, seconds, view.kind), "kernel.topk_roofline")
