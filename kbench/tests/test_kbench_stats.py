"""The metric arithmetic: a rate is every query over the whole window; the
95th percentile is over every query, so a stall shows."""

import pytest

from kbench import clock, harness, stats


class _Plan:
    def query(self, i):
        return i

    def warm(self):
        return []


def _spin(ms):
    end = clock.now() + ms / 1e3
    while clock.now() < end:
        pass


def test_nearest_rank_is_over_all_values():
    # 100 fast queries and a stall of 10: the stall is the 95th percentile,
    # where a median of chunks of 10 would read 1 ms everywhere
    lat = [1.0] * 100 + [500.0] * 10
    assert stats.nearest_rank(lat, 0.95) == 500.0
    assert stats.nearest_rank(lat, 0.5) == 1.0
    assert stats.nearest_rank([3.0], 0.95) == 3.0
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.95)


def test_rate_is_all_queries_over_the_window():
    assert stats.rate(500, 10.0) == 50.0


def test_window_counts_every_query_and_its_stall():
    def call(inputs, q):
        if q % 10 == 9:
            _spin(30.0)
        return q

    w = harness.run_window(call, {}, _Plan(), 0.6, harness.Timer("cpu"), True, 0, 1)
    n = len(w.latencies_ms)
    assert n == len(w.kept) and n >= 10
    assert w.seconds >= 0.6
    stalls = sum(x >= 30.0 for x in w.latencies_ms)
    assert stalls == n // 10
    assert stats.nearest_rank(w.latencies_ms, 0.95) >= 30.0
    assert stats.rate(n, w.seconds) <= n / 0.6


def test_window_counts_a_failed_query():
    def call(inputs, q):
        if q == 2:
            raise ValueError("planted")
        return q

    w = harness.run_window(call, {}, _Plan(), 0.05, harness.Timer("cpu"), True, 0, 1)
    assert w.failed == 1 and len(w.kept) == len(w.latencies_ms) - 1


def test_sample_is_fixed_size_and_seeded():
    def call(inputs, q):
        return q

    a = harness.run_window(call, {}, _Plan(), 0.05, harness.Timer("cpu"), False, 8, 5)
    assert len(a.kept) == 8 and len(a.latencies_ms) > 8
    assert len({i for i, _, _ in a.kept}) == 8


def test_spread_is_interquartile_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)
