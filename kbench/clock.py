"""The benchmark's host clock, in one place.

The host clock times only spans of 250 ms or more: the measured window and
the set-up. A query's latency comes from CUDA events (harness.py).
"""

from __future__ import annotations

import time


def now() -> float:
    """Seconds on the host's monotonic performance counter."""
    return time.perf_counter()  # ksel: noqa[KSL004] -- the benchmark's own clock, read only around spans of >= 250 ms (window, set-up)
