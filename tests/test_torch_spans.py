"""The port's spans (utils/profiling.py:``span``) in ``torch.profiler``
traces: off, they are one shared null context and never enter
``record_function``; on, each entry point, descent pass, host read, collect
step and kernel wrapper call is one ``user_annotation`` range, nested in its
caller's, and the answers keep their bits.

The ``gpu`` test runs a select on the card and reads its device ranges:

    python -m pytest --noconftest tests/test_torch_spans.py -m gpu
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.obs import Observability
from mpi_k_selection_tpu_torch.obs.events import ListSink
from mpi_k_selection_tpu_torch.obs.trace import TraceRecorder
from mpi_k_selection_tpu_torch.utils import profiling
from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

N = 1 << 16


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(24)
    return torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, size=N, dtype=np.int32))


def _traced(tmp_path, fn, cuda=False):
    """``fn()`` under the profiler: its result and the trace's complete
    events ``(cat, name, ts, end)``, in start order."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [(e.get("cat", ""), e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return out, sorted(evs, key=lambda e: e[2])


def _spans(evs, cat="user_annotation"):
    return [e for e in evs if e[0] == cat and e[1].startswith("ksel.")]


def _names(spans):
    return [e[1] for e in spans]


def _inside(inner, outer, slack=0.01):
    """``inner`` lies in ``outer`` (the trace rounds times to the
    nanosecond, so an end may pass its parent's by that much)."""
    return outer[2] - slack <= inner[2] and inner[3] <= outer[3] + slack


def test_span_off_is_one_shared_null_context(monkeypatch, x):
    """With the profiler off and no timer, every span is the same null
    context and ``record_function`` is never entered, along every resident
    path and every phase of a timer."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("ksel.kselect"), profiling.span("ksel.collect")
    assert a is b and a is profiling._OFF
    with a:
        with b:
            pass
    kt.kselect(x, 1000, cutover=3)
    kt.kselect(x, 1000, early_exit_budget=64)
    kt.quantiles(x, [0.1, 0.5, 0.9], cutover=3)
    kt.batched_topk(torch.randn(64, 4096), 8)
    timer = PhaseTimer()
    with profiling.span("ksel.kselect", timer):
        pass
    assert timer.counts == {"ksel.kselect": 1}


def test_kselect_spans_nest_in_the_entry_span(tmp_path, x):
    """A kselect whose first rung fits: one entry span holding 3 passes (each
    one wrapper call), one host read, and one collect with its three steps
    in order."""
    _, evs = _traced(tmp_path, lambda: kt.kselect(x, 1000, cutover=3))
    spans = _spans(evs)
    names = _names(spans)
    (entry,) = [s for s in spans if s[1] == "ksel.kselect"]
    assert all(_inside(s, entry) for s in spans)
    assert names.count("ksel.descent.pass") == 3
    assert names.count("ksel.descent.host_read") == 1
    assert names.count("ksel.collect") == 1
    top = [n for n in names if n in ("ksel.descent.pass", "ksel.descent.host_read", "ksel.collect")]
    assert top == ["ksel.descent.pass"] * 3 + ["ksel.descent.host_read", "ksel.collect"]
    (collect,) = [s for s in spans if s[1] == "ksel.collect"]
    steps = [s[1] for s in spans if s[1].startswith("ksel.collect.")]
    assert steps == ["ksel.collect.match", "ksel.collect.gather", "ksel.collect.pick"]
    assert all(_inside(s, collect) for s in spans if s[1].startswith("ksel.collect."))
    # one wrapper call a pass and one in the collect's match step
    assert names.count("ksel.launch") == 4
    for s in spans:
        if s[1] == "ksel.descent.pass":
            assert sum(_inside(w, s) for w in spans if w[1] == "ksel.launch") == 1


def test_early_exit_reads_once_a_pass(tmp_path, x):
    """``early_exit_budget``: after each pass, one population read, until one
    fits (about 16 keys after the third 4-bit pass of 2^16 spread keys)."""
    _, evs = _traced(tmp_path, lambda: kt.kselect(x, 1000, early_exit_budget=64))
    names = [n for n in _names(_spans(evs)) if n in ("ksel.descent.pass", "ksel.descent.host_read", "ksel.collect")]
    assert names == ["ksel.descent.pass", "ksel.descent.host_read"] * 3 + ["ksel.collect"]


def test_quantiles_take_the_walk_inside_their_entry_spans(tmp_path, x):
    """``quantiles`` is one ``ksel.quantiles`` span around one
    ``ksel.kselect_many``, which takes the ``radix-many`` leg: the shared
    passes, one read of the largest population, one K-wide collect."""
    obs = Observability(events=ListSink())
    _, evs = _traced(tmp_path, lambda: kt.quantiles(x, [0.1, 0.5, 0.9], cutover=3, obs=obs))
    assert obs.events.events[-1].algorithm == "radix-many"
    spans = _spans(evs)
    (q,) = [s for s in spans if s[1] == "ksel.quantiles"]
    (many,) = [s for s in spans if s[1] == "ksel.kselect_many"]
    assert _inside(many, q) and all(_inside(s, q) for s in spans)
    assert all(_inside(s, many) for s in spans if s[1] not in ("ksel.quantiles", "ksel.kselect_many"))
    names = _names(spans)
    assert (names.count("ksel.descent.pass"), names.count("ksel.descent.host_read"), names.count("ksel.collect")) \
        == (3, 1, 1)
    assert "ksel.kselect" not in names


def test_batched_topk_is_one_topk_span(tmp_path):
    rows = torch.randn(64, 4096, generator=torch.Generator().manual_seed(24))
    _, evs = _traced(tmp_path, lambda: kt.batched_topk(rows, 8))
    assert _names(_spans(evs)) == ["ksel.topk"]


CALLS = {
    "kselect": lambda x: kt.kselect(x, 1000, cutover=3),
    "early_exit": lambda x: kt.kselect(x, N // 2, early_exit_budget=64),
    "fixed": lambda x: kt.kselect(x, 77, cutover=None),
    "kselect_many": lambda x: kt.kselect_many(x, torch.tensor([1, 500, N // 2, N]), cutover=3),
    "quantiles": lambda x: kt.quantiles(x, [0.01, 0.5, 0.99], cutover=3),
    "median": lambda x: kt.median(x),
    "topk_threshold": lambda x: kt.topk(x, 9, method="threshold"),
    "batched_topk": lambda x: kt.batched_topk(x[:1 << 14].view(4, 4096).float(), 8),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_answers_keep_their_bits_with_the_profiler_on(tmp_path, x, name):
    call = CALLS[name]
    off = call(x)
    on, _ = _traced(tmp_path, lambda: call(x))
    off = off if isinstance(off, tuple) else (off,)
    on = on if isinstance(on, tuple) else (on,)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def test_phase_timer_phase_is_a_user_annotation_and_still_recorded(tmp_path):
    """A timer's phase is a ``record_function`` range while the profiler
    records, and its recorder still gets the span; ``span`` with a timer is
    that phase, and ``phase`` without one is a range alone."""
    rec = TraceRecorder()
    timer = PhaseTimer(recorder=rec)

    def work():
        with timer.phase("descent.pass"):
            torch.arange(100).sum()
        with profiling.span("ksel.collect", timer):
            torch.arange(100).sum()
        with profiling.phase(None, "pipeline.stage"):
            torch.arange(100).sum()

    _, evs = _traced(tmp_path, work)
    ann = [e for e in evs if e[0] == "user_annotation"]
    assert [e[1] for e in ann] == ["descent.pass", "ksel.collect", "pipeline.stage"]
    assert [s.name for s in rec.snapshot()] == ["descent.pass", "ksel.collect"]
    assert timer.counts == {"descent.pass": 1, "ksel.collect": 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_trace_holds_the_spans_and_their_device_ranges(tmp_path, cuda_device, x):
    """On the card: the same spans, each wrapper call launching its kernel,
    and, where the profiler emits device ranges (``gpu_user_annotation``,
    one for the innermost span open at each launch), each histogram and
    match-count kernel inside a ``ksel.launch`` range."""
    xc = x.to(cuda_device)
    want = kt.kselect(x, 1000, cutover=3)
    got, evs = _traced(tmp_path, lambda: kt.kselect(xc, 1000, cutover=3), cuda=True)
    assert torch.equal(got.cpu(), want)
    names = _names(_spans(evs))
    assert names.count("ksel.kselect") == 1 and names.count("ksel.descent.pass") == 3
    assert names.count("ksel.descent.host_read") == 1 and names.count("ksel.collect") == 1
    assert names.count("ksel.launch") == 4
    kernels = [e for e in evs if e[0] == "kernel"]
    assert sum("radix_histogram_kernel" in e[1] for e in kernels) == 3
    assert sum("match_counts_kernel" in e[1] for e in kernels) == 1
    ranges = _spans(evs, "gpu_user_annotation")
    if ranges:
        assert {r[1] for r in ranges} <= set(names)
        launched = [r for r in ranges if r[1] == "ksel.launch"]
        for k in kernels:
            if "radix_histogram_kernel" in k[1] or "match_counts_kernel" in k[1]:
                assert any(_inside(k, r) for r in launched), k
