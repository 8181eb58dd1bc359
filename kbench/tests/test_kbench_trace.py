"""The trace reader counts before it divides: a recorded trace fixture."""

import pathlib

import pytest

from kbench import harness, manifest
from kbench import trace as tr

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "trace_small.json"
H100 = "NVIDIA H100 80GB HBM3"
BOOKS = {"radix_histogram32": 2, "radix_histogram_multi32": 1, "match_counts32": 1, "tau_counts32": 0}


def _view(books=BOOKS, n=1 << 20, kind=H100, queries=2):
    return tr.View(tr.load_chrome(FIXTURE), queries, dict(books), kind, {"dtype": "int32", "n": n}, {},
                   least_bytes=n * 4)


def test_window_and_busy_time():
    v = _view()
    assert v.window_s == pytest.approx(1e-3)
    # kernels, copies and sets inside the window only (the one at 2500 us is out)
    assert len(v.device) == 6
    assert v.busy_s == pytest.approx((100 + 50 + 80 + 10 + 100 + 30) * 1e-6)
    assert len(v.dtoh_copies()) == 1


def test_group_counts_against_the_books():
    n, seconds = _view().group([r"\bradix_histogram_kernel\b", r"\bradix_histogram_multi_kernel\b"],
                               ["radix_histogram32", "radix_histogram_multi32"])
    assert n == 3 and seconds == pytest.approx(250e-6)
    with pytest.raises(tr.CountMismatch):
        _view({**BOOKS, "radix_histogram32": 3}).group([r"\bradix_histogram_kernel\b"], ["radix_histogram32"])


def _reader(name):
    return manifest.load_module(manifest.metric_file(manifest.ROOT, name), "metric").read


def test_readers_on_the_fixture():
    v = _view()
    assert _reader("descent.hist_launches")(v) == 1.5
    assert _reader("descent.host_syncs")(v) == 0.5
    assert _reader("device.idle_pct")(v) == pytest.approx(100 * (1 - 370 / 1000))
    hist = _reader("kernel.hist_roofline")(v)
    assert hist == pytest.approx(100 * (3 * (1 << 22) / 3.35e12) / 250e-6)
    match = _reader("kernel.match_roofline")(v)
    assert match == pytest.approx(100 * (((1 << 22) + (1 << 13) * 4) / 3.35e12) / 80e-6)
    work = _reader("device.work_roofline")(v)
    assert work == pytest.approx(100 * (2 * (1 << 22) / 3.35e12) / 370e-6)
    assert _reader("kernel.topk_roofline")(v) is None  # no launch of its kernel: nothing to read


def test_reader_refuses_a_share_when_counts_disagree(capsys):
    cell = manifest.Cell(manifest.load(), "keys-i32-1g.select")
    v = _view({**BOOKS, "match_counts32": 2})  # one match launch lost from the trace
    out = harness.read_layers(cell, v)
    assert "kernel.match_roofline" not in out and "device.work_roofline" not in out
    assert "kernel.hist_roofline" in out and "device.idle_pct" in out
    assert "not reported" in capsys.readouterr().err


def test_share_over_100_fails_loudly():
    v = _view(n=1 << 30)  # the same time for 1024x the bytes
    with pytest.raises(tr.ShareOver100):
        _reader("kernel.hist_roofline")(v)


def test_no_peak_no_share():
    assert _reader("kernel.hist_roofline")(_view(kind="some other card")) is None


def test_breakdown():
    b = _view().breakdown()
    assert b["device_ops"][0][0].startswith("void radix_histogram_kernel")
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    assert len(b["device_ops"]) <= tr.TOP and len(b["idle_gaps"]) <= tr.TOP
    gaps = dict(b["idle_gaps"])
    # the gaps at the window's end lie under the host's stream sync
    assert gaps["cudaStreamSynchronize"] == pytest.approx((2000 - 1650) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(630e-6)


def test_the_window_mark_must_be_there_once(tmp_path):
    with pytest.raises(ValueError):
        tr.View([], 1)
