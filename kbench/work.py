"""The yardstick's arithmetic: the least bytes a query or a kernel launch
needs, and the device peaks they are held against.

Bytes count each input byte read once and each output byte written once,
what the answer needs whatever a kernel reads again. A share of a roofline
is the least time (bytes over the peak rate) over the measured device time;
it cannot pass 100% unless the bytes are counted too high or the time leaves
out work.
"""

from __future__ import annotations

# Published peaks by ``torch.cuda.get_device_name()``: NVIDIA's H100 SXM data
# sheet (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores),
# at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}

ROW = 128  # keys per row of the collect's per-row match counts (the port's ROW)
COUNT_BYTES = 4  # the match counts are int32
INDEX_BYTES = 8  # positions are int64


def peak(kind: str, what: str) -> float | None:
    """The device's published ``what`` peak, None for a device not in the
    table (a share is then not reported)."""
    return PEAKS.get(kind, {}).get(what)


def select_query_bytes(n: int, itemsize: int, n_answers: int = 1) -> int:
    """An exact selection of ``n_answers`` ranks over ``n`` keys: every key
    read once, each answer written once."""
    return n * itemsize + n_answers * itemsize


def histogram_launch_bytes(n: int, itemsize: int) -> int:
    """One histogram pass of the descent (rows 1 and 3): every key read once
    (the 16 counters a prefix it writes are under a millionth of it and left
    out, which can only lower the share)."""
    return n * itemsize


def match_launch_bytes(n: int, itemsize: int, n_prefixes: int) -> int:
    """One launch of the collect's match-count kernel (row 5): every key read
    once, and one int32 count a prefix for every row of ``ROW`` keys written."""
    rows = -(-n // ROW)
    return n * itemsize + n_prefixes * rows * COUNT_BYTES


def topk_bytes(batch: int, width: int, k: int, itemsize: int) -> int:
    """A batched top-k of ``(batch, width)``: the batch read once, the k values
    and int64 positions of every row written once."""
    return batch * width * itemsize + batch * k * (itemsize + INDEX_BYTES)


def roofline_pct(nbytes_total: float, device_s: float, kind: str) -> float | None:
    """The share (in %) of the bandwidth roofline that ``nbytes_total`` moved
    in ``device_s`` seconds of device time reaches; None without a peak or
    without time."""
    rate = peak(kind, "hbm_bytes_per_s")
    if rate is None or device_s <= 0:
        return None
    return 100.0 * (nbytes_total / rate) / device_s
