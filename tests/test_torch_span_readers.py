"""The benchmark's readers of the port's spans (``kbench/metrics/``:
``dispatch.host_us``, ``descent.host_reads``, ``descent.read_bubble_us``,
``descent.collect_ms``) on a small hand-made Chrome trace laid out as
``torch.profiler`` exports one (``kbench/tests/fixtures/trace_small.json``):
each reading worked out by hand, nothing read from a trace without
``ksel.`` spans, the collect's reading equal to the ops launched inside it,
lost device records and an offset between the clocks read through, and the
manifest's entries valid. ``_card`` adds the device ranges as the card's
profiler gives them: one a span, over the ops launched while it was the
innermost span open.
"""

from __future__ import annotations

import json
import pathlib

import pytest

from kbench import harness, manifest
from kbench import trace as tr

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARENT_FIXTURE = ROOT / "kbench" / "tests" / "fixtures" / "trace_small.json"
NEW = ("dispatch.host_us", "descent.host_reads", "descent.read_bubble_us", "descent.collect_ms")
HIST = "void radix_histogram_kernel<unsigned int>(unsigned int const*, long long, int, int, int, unsigned int, " \
       "unsigned int, int*)"
MATCH = "void match_counts_kernel<unsigned int, true, 1, 4>(unsigned int const*, long long, long long, int)"
SCAN = "void at::native::tensor_kernel_scan_innermost_dim<long>(long*, long const*, unsigned int, unsigned int)"
SORT = "void at::native::bitonicSortKVInPlace<2, -1, 16, 16, long, long, at::native::LTOp<long, true>>(...)"
MAX = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long, at::native::MaxOps<long>>>(...)"


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0 if cat in tr.DEVICE_CATS else 1, "tid": tid,
            "ts": float(ts), "dur": float(dur)}


def _host(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _rt(name, ts, dur=4.0):
    return _x("cuda_runtime", name, ts, dur)


def _dev(cat, name, ts, dur):
    return _x(cat, name, ts, dur, tid=7)


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def _card(events, lose=lambda op: False):
    """``events`` with the device ranges the card's profiler adds: each
    device op (paired with its launching call in order, one stream) goes
    to the innermost annotation open at its launch, and each annotation
    that launched ops gets one range over them. Ops for which ``lose``
    holds lose their record, and their ranges are made without them."""
    calls = sorted((e for e in events if e["cat"] == "cuda_runtime" and e["name"] in LAUNCH_CALLS),
                   key=lambda e: e["ts"])
    ops = sorted((e for e in events if e["cat"] in tr.DEVICE_CATS), key=lambda e: e["ts"])
    assert len(calls) == len(ops)
    notes = [e for e in events if e["cat"] == "user_annotation"]
    groups = {}
    for call, op in zip(calls, ops):
        open_ = [i for i, e in enumerate(notes) if e["ts"] <= call["ts"] < e["ts"] + e["dur"]]
        inner = max(open_, key=lambda i: (notes[i]["ts"], -notes[i]["dur"]))
        if not lose(op):
            groups.setdefault(inner, []).append(op)
    ranges = [_x("gpu_user_annotation", notes[i]["name"], min(o["ts"] for o in g),
                 max(o["ts"] + o["dur"] for o in g) - min(o["ts"] for o in g), tid=7) for i, g in groups.items()]
    return [e for e in events if not (e["cat"] in tr.DEVICE_CATS and lose(e))] + ranges


# Query 1, a kselect (1000-1900 us): two passes, one host read, a collect of
# four device ops. Query 2, quantiles around kselect_many (2000-2800 us): the
# ranks copied in, one pass, a read of the largest population (a max kernel
# and the copy), a collect of two device ops. Every launch is followed by its
# device op in the same order (one stream); ``_card`` adds the device ranges.
EVENTS = [
    _host("kbench.window", 1000, 2000),
    _host("ksel.kselect", 1000, 900),
    _host("ledger.compile.api.select", 1005, 2),  # another program span: no reader takes it
    _host("ksel.descent.pass", 1010, 40), _host("ksel.launch", 1012, 30), _rt("cudaLaunchKernel", 1020),
    _dev("kernel", HIST, 1030, 100),
    _host("ksel.descent.pass", 1060, 40), _host("ksel.launch", 1062, 30), _rt("cudaLaunchKernel", 1070),
    _dev("kernel", HIST, 1130, 100),
    _host("ksel.descent.host_read", 1110, 150), _rt("cudaMemcpyAsync", 1120), _rt("cudaStreamSynchronize", 1125, 130),
    _dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1230, 10),
    _host("ksel.collect", 1300, 400),
    _host("ksel.collect.match", 1300, 40), _host("ksel.launch", 1302, 30), _rt("cudaLaunchKernel", 1310),
    _dev("kernel", MATCH, 1320, 80),
    _host("ksel.collect.gather", 1350, 250), _rt("cudaLaunchKernel", 1360), _rt("cudaLaunchKernel", 1500),
    _dev("kernel", SCAN, 1400, 50), _dev("kernel", SCAN, 1510, 50),
    _host("ksel.collect.pick", 1600, 100), _rt("cudaLaunchKernel", 1650),
    _dev("kernel", SORT, 1660, 40),
    _rt("cudaEventRecord", 1950), _rt("cudaEventSynchronize", 1955, 20),
    _host("ksel.quantiles", 2000, 800),
    _host("ksel.kselect_many", 2010, 780),
    _rt("cudaMemcpyAsync", 2015), _dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2020, 5),
    _host("ksel.descent.pass", 2030, 30), _rt("cudaLaunchKernel", 2040), _dev("kernel", HIST, 2050, 100),
    _host("ksel.descent.host_read", 2100, 100), _rt("cudaLaunchKernel", 2105), _rt("cudaMemcpyAsync", 2110),
    _dev("kernel", MAX, 2150, 10), _dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2160, 10),
    _host("ksel.collect", 2300, 300),
    _host("ksel.collect.match", 2300, 50), _rt("cudaLaunchKernel", 2310), _dev("kernel", MATCH, 2320, 180),
    _host("ksel.collect.pick", 2500, 100), _rt("cudaLaunchKernel", 2550), _dev("kernel", SORT, 2560, 20),
    _host("ksel.kselect", 3500, 100),  # after the window: not read
]
BOOKS = {"radix_histogram32": 3, "match_counts32": 2}
QUERIES = 2
CONFIG = {"dtype": "int32", "n": 1 << 20}

# by hand, a query:
HOST_US = ((900 - 150) + (800 - 100)) / 2  # the outermost entry spans less their host reads
HOST_READS = 2 / 2
BUBBLE_US = ((1320 - 1240) + (2320 - 2170)) / 2  # from the read's copy to the next device op
COLLECT_MS = ((80 + 50 + 50 + 40) + (180 + 20)) / 1e3 / 2


def _view(tmp_path, events=None, name="trace.json", queries=QUERIES):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": _card(EVENTS) if events is None else events}))
    return tr.View(tr.load_chrome(path), queries, dict(BOOKS), "NVIDIA H100 80GB HBM3", dict(CONFIG), {},
                   least_bytes=CONFIG["n"] * 4)


def _read(name, view):
    return manifest.load_module(manifest.metric_file(manifest.ROOT, name), "metric").read(view)


def test_readings_worked_out_by_hand(tmp_path):
    v = _view(tmp_path)
    assert _read("dispatch.host_us", v) == pytest.approx(HOST_US)
    assert _read("descent.host_reads", v) == HOST_READS
    assert _read("descent.read_bubble_us", v) == pytest.approx(BUBBLE_US)
    assert _read("descent.collect_ms", v) == pytest.approx(COLLECT_MS)
    # the port's count of host reads equals the trace's device-to-host copies here
    assert _read("descent.host_syncs", v) == HOST_READS


def test_a_read_followed_at_once_by_device_work_costs_no_bubble(tmp_path):
    """The first query's match-count kernel starts as its read's copy ends:
    no idle gap holds that read's end."""
    at_once = [{**e, "ts": 1240.0} if e["name"] == MATCH and e["ts"] == 1320 else e for e in EVENTS]
    assert _read("descent.read_bubble_us", _view(tmp_path, _card(at_once))) == pytest.approx((2320 - 2170) / 2)


@pytest.mark.parametrize("trace_of", ["the parent's fixture", "spans stripped"])
def test_nothing_read_without_ksel_spans(tmp_path, trace_of):
    """The parent emits no ``ksel.`` span: every reader gives None, not 0."""
    if trace_of == "the parent's fixture":
        v = tr.View(tr.load_chrome(PARENT_FIXTURE), 2, {"radix_histogram32": 2}, "NVIDIA H100 80GB HBM3",
                    dict(CONFIG), {})
    else:
        v = _view(tmp_path, [e for e in _card(EVENTS) if not e["name"].startswith("ksel.")])
    for name in NEW:
        assert _read(name, v) is None, name


def _many_selects(count, lose=()):
    """``count`` copies of the fixture's first query, 1000 us apart, with the
    card's device ranges; the copies in ``lose`` lost their match-count
    kernel's record."""
    first = [e for e in EVENTS if 1000 <= e["ts"] < 2000 and e["name"] != "kbench.window"]
    out = [_host("kbench.window", 1000, 1000 * count)]
    for q in range(count):
        out += [{**e, "ts": e["ts"] + 1000 * q} for e in first]
    return _card(out, lambda op: op["name"] == MATCH and (op["ts"] - 1320) // 1000 in lose)


def _launched_in_collect(events):
    """The busy time of the device ops launched inside ``ksel.collect``
    spans, in ms a query of ``events``' window, found by pairing the whole
    fixture's launches with its ops in order."""
    calls = sorted((e for e in events if e["cat"] == "cuda_runtime" and e["name"] in LAUNCH_CALLS),
                   key=lambda e: e["ts"])
    ops = sorted((e for e in events if e["cat"] in tr.DEVICE_CATS), key=lambda e: e["ts"])
    spans = [e for e in events if e["name"] == "ksel.collect"]
    inside = [(o["ts"], o["ts"] + o["dur"]) for c, o in zip(calls, ops)
              if any(s["ts"] <= c["ts"] < s["ts"] + s["dur"] for s in spans)]
    return sum(e - s for s, e in tr.merge(inside)) / 1e3


@pytest.mark.parametrize("fixture", ["two queries", "twenty selects"])
def test_collect_equals_the_ops_launched_inside_it(tmp_path, fixture):
    """The reader reads the collect off the device ranges alone (the card
    gives a range to the innermost span open at a launch only); it reads
    what the ops launched inside ``ksel.collect`` take, and no op of the
    passes or of the next query's first launch."""
    events, queries = (_card(EVENTS), QUERIES) if fixture == "two queries" else (_many_selects(20), 20)
    assert not [e for e in events if e["cat"] == "gpu_user_annotation" and e["name"] == "ksel.collect"]
    v = _view(tmp_path, events, queries=queries)
    assert _read("descent.collect_ms", v) == pytest.approx(_launched_in_collect(events) / queries)


def test_a_lost_device_record_leaves_out_its_op_alone(tmp_path):
    """The profiler dropped the first pick's sort (its range goes with it)
    and, apart, the first read's copy: the collect reads 40 us short, the
    bubble is the other read's, and nothing is refused."""
    no_sort = _card(EVENTS, lambda op: op["name"] == SORT and op["ts"] == 1660)
    assert _read("descent.collect_ms", _view(tmp_path, no_sort)) == pytest.approx(COLLECT_MS - 40 / 1e3 / 2)
    no_copy = _card(EVENTS, lambda op: op["ts"] == 1230)
    assert _read("descent.read_bubble_us", _view(tmp_path, no_copy)) == pytest.approx(2320 - 2170)


def test_lost_records_in_many_queries_still_read(tmp_path):
    """Eight of 150 queries lost their match-count kernel's record, as the
    profiler drops one in a process's later sessions: each such collect
    reads 80 us short, and its read's gap runs on to the gather's first op."""
    lose = {7, 20, 40, 60, 80, 100, 120, 140}
    v = _view(tmp_path, _many_selects(150, lose), queries=150)
    assert _read("descent.collect_ms", v) == pytest.approx((220 - 80 * len(lose) / 150) / 1e3)
    assert _read("descent.read_bubble_us", v) == pytest.approx(((150 - 8) * (1320 - 1240) + 8 * (1400 - 1240)) / 150)


@pytest.mark.parametrize("offset_us", [-1300.0, -25.0, 350.0])
def test_readings_hold_under_an_offset_between_the_clocks(tmp_path, offset_us):
    """The device's records shifted against the host's (as the profiler's
    conversion between the two clocks can leave them): ops now start before
    their launch or the window, or after the next query's entry span has
    begun. The readers read the device's clock alone, so they read the same."""
    shifted = [{**e, "ts": e["ts"] + offset_us} if e["cat"] in tr.DEVICE_CATS | {"gpu_user_annotation"} else e
               for e in _many_selects(20)]
    v = _view(tmp_path, shifted, queries=20)
    assert _read("descent.collect_ms", v) == pytest.approx((80 + 50 + 50 + 40) / 1e3)
    assert _read("descent.read_bubble_us", v) == pytest.approx(1320 - 1240)


def test_the_harness_ops_after_a_collect_are_not_the_collects(tmp_path):
    """A device op the harness launches after the query, outside any
    ``ksel.`` span, is not read as the collect's."""
    extra = EVENTS + [_rt("cudaLaunchKernel", 1960), _dev("kernel", SCAN, 1970, 30)]
    assert _read("descent.collect_ms", _view(tmp_path, _card(extra))) == pytest.approx(COLLECT_MS)


def test_a_window_without_a_collect_reads_zero_collect_time(tmp_path):
    no_collect = [e for e in EVENTS if not e["name"].startswith("ksel.collect")]
    assert _read("descent.collect_ms", _view(tmp_path, _card(no_collect))) == 0.0


def test_a_trace_without_device_ranges_reads_no_device_time(tmp_path):
    """A trace with the spans but no device ranges (a CPU run): the host's
    readings stand, the readers of device time give None."""
    v = _view(tmp_path, [e for e in EVENTS if e["cat"] not in tr.DEVICE_CATS])
    assert _read("dispatch.host_us", v) == pytest.approx(HOST_US)
    assert _read("descent.host_reads", v) == HOST_READS
    assert _read("descent.read_bubble_us", v) is None
    assert _read("descent.collect_ms", v) is None


def test_manifest_takes_the_four_span_metrics():
    man = manifest.load()
    assert manifest.problems(man) == []
    entries = {m["name"]: m for m in man["per_layer"]}
    keys = ["keys-i32-1g.select", "keys-i32-1g.pct99"]
    want = {
        "dispatch.host_us": ("us/query", "dispatch (api.py, ops/topk.py)", [w["name"] for w in man["workloads"]]),
        "descent.host_reads": ("reads/query", "descent and walk (ops/radix.py)", keys),
        "descent.read_bubble_us": ("us/query", "descent and walk (ops/radix.py)", keys),
        "descent.collect_ms": ("ms/query", "descent and walk (ops/radix.py)", keys),
    }
    assert [m["name"] for m in man["per_layer"]][-4:] == list(want)
    for name, (unit, layer, cells) in want.items():
        m = entries[name]
        assert (m["unit"], m["layer"], m["better"], m["source"], m["moves"]) == \
            (unit, layer, "lower", "program_span", "queries_per_s")
        assert sorted(m["workloads"]) == sorted(cells)
        assert manifest.UNIT_RE.fullmatch(unit) and manifest.metric_file(manifest.ROOT, name).is_file()


def test_a_cells_traced_line_reports_the_span_metrics_beside_the_old_ones(tmp_path):
    cell = manifest.Cell(manifest.load(), "keys-i32-1g.select")
    cell.config.update(CONFIG)
    out = harness.read_layers(cell, _view(tmp_path))
    assert set(NEW) <= set(out) and "descent.hist_launches" in out and "kernel.match_roofline" in out
    assert out["descent.host_reads"] == {"value": HOST_READS, "unit": "reads/query"}
