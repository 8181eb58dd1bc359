"""The byte counts and the roofline arithmetic."""

import pytest

from kbench import work

H100 = "NVIDIA H100 80GB HBM3"


def test_select_reads_every_key_once():
    assert work.select_query_bytes(1 << 30, 4) == (1 << 32) + 4
    assert work.select_query_bytes(1 << 30, 4, 99) == (1 << 32) + 99 * 4


def test_histogram_launch_reads_every_key_once():
    assert work.histogram_launch_bytes(1 << 30, 4) == 1 << 32


def test_match_launch_reads_keys_and_writes_a_count_a_row_a_prefix():
    rows = (1 << 30) // 128
    assert work.match_launch_bytes(1 << 30, 4, 1) == (1 << 32) + rows * 4
    assert work.match_launch_bytes(1 << 30, 4, 99) == (1 << 32) + 99 * rows * 4
    assert work.match_launch_bytes(129, 4, 1) == 129 * 4 + 2 * 4  # a partial row counts


def test_topk_reads_the_batch_and_writes_values_and_positions():
    assert work.topk_bytes(4096, 32768, 8, 4) == 4096 * 32768 * 4 + 4096 * 8 * 12
    assert work.topk_bytes(4096, 32768, 50, 2) == 4096 * 32768 * 2 + 4096 * 50 * 10


def test_roofline_share():
    # 3.35 GB in 1 ms is the peak; in 2 ms half of it
    assert work.roofline_pct(3.35e9, 1e-3, H100) == pytest.approx(100.0)
    assert work.roofline_pct(3.35e9, 2e-3, H100) == pytest.approx(50.0)
    assert work.roofline_pct(3.35e9, 1e-3, "some other card") is None
    assert work.roofline_pct(3.35e9, 0.0, H100) is None
