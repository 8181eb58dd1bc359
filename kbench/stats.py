"""Statistics of a run's readings."""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The nearest-rank ``q``-quantile (0 < q <= 1) of ``values``: an observed
    value, taken over all of them."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(1, math.ceil(q * len(s))) - 1]


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``), the spread the bounds are
    set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
