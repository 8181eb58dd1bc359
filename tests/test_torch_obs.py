"""The port's telemetry (``mpi_k_selection_tpu_torch/obs/``, utils/
profiling.py) against the JAX package's (tests/test_obs.py).

Answers are the same bits with telemetry on and off over the devices x
pipeline_depth x spill grid, and the event streams equal the JAX
package's entry for entry (``as_dict``) on the same seeded chunks:
``stream.pass``, ``stream.chunk``, ``spill.generation``, ``sketch.pass``,
``certificate.pass``, ``resident.select`` and ``distributed.select`` (at
world 2 over gloo). The only events left out of a comparison are the
ledgers' ``ledger.recompile_storm``: each package's process ledger fires
them by its own history of launches. The registry's Prometheus text and
JSON equal the JAX registry's for the same records. ``gpu`` tests hold
the telemetry's bit-identity on the card:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch import obs as obs_lib
from mpi_k_selection_tpu_torch.obs.metrics import collect_runtime
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer
from test_torch_streaming import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(1)

CPU = dict(device="cpu")
STORM = "ledger.recompile_storm"


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _chunks(rng, sizes=(5000, 4096, 2048, 4096, 1000), dtype=np.int32):
    return [rng.integers(-(2**31), 2**31 - 1, size=m, dtype=np.int64).astype(dtype) for m in sizes]


def _oracle(chunks, k):
    return np.sort(np.concatenate([c.ravel() for c in chunks]), kind="stable")[k - 1]


def _stream(events) -> list:
    """An event stream as dicts, the ledgers' storm events left out."""
    return [e.as_dict() for e in events if e.kind != STORM]


def _jax_obs():
    from mpi_k_selection_tpu import obs as jobs

    return jobs.Observability.collecting()


@pytest.mark.parametrize("devices", [None, 2, 8])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("spill", ["off", "force"])
def test_obs_bit_identical_grid_and_events_match_jax(rng, devices, depth, spill, tmp_path):
    """The answer with every channel on equals the one with none and the
    JAX package's, the stream passes ``check_stream_invariants`` (against
    the store's ``pass_log`` when spilling), and the event stream equals
    the JAX package's entry for entry."""
    from mpi_k_selection_tpu.streaming.chunked import streaming_kselect as ref_select
    from mpi_k_selection_tpu.streaming.spill import SpillStore as JaxStore

    chunks = _chunks(rng)
    n = sum(c.size for c in chunks)
    k = n // 2
    kw = dict(radix_bits=4, collect_budget=64, pipeline_depth=depth, devices=devices)
    want = _oracle(chunks, k)
    o, jo = obs_lib.Observability.collecting(), _jax_obs()
    if spill == "off":
        plain = kt.kselect_streaming(chunks, k, spill="off", **kw, **CPU)
        got = kt.kselect_streaming(chunks, k, spill="off", obs=o, **kw, **CPU)
        ref = ref_select(chunks, k, spill="off", obs=jo, **kw)
        log = None
    else:
        with kt.SpillStore(str(tmp_path / "a")) as s1, kt.SpillStore(str(tmp_path / "b")) as s2, \
                JaxStore(str(tmp_path / "c")) as s3:
            plain = kt.kselect_streaming(chunks, k, spill=s1, **kw, **CPU)
            got = kt.kselect_streaming(chunks, k, spill=s2, obs=o, **kw, **CPU)
            ref = ref_select(chunks, k, spill=s3, obs=jo, **kw)
            log = list(s2.pass_log)
            assert log == list(s1.pass_log) == list(s3.pass_log)
    assert plain == got == ref == want
    obs_lib.check_stream_invariants(o.events.events, spill_pass_log=log)
    assert len(o.events.of_kind("stream.pass")) >= 2
    assert _stream(o.events.events) == _stream(jo.events.events)


def test_obs_multirank_f64_and_metrics_match_jax(rng):
    """Four ranks over float64: answers on and off equal, one survivor
    population a rank in every pass event, the streams equal the JAX
    package's, and so do the per-slot chunk and byte counters."""
    from mpi_k_selection_tpu.streaming.chunked import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = _chunks(rng, sizes=(3000, 2048, 1000), dtype=np.float64)
    n = sum(c.size for c in chunks)
    ks = [1, n // 3, n // 2, n]
    o, jo = obs_lib.Observability.collecting(), _jax_obs()
    got = kt.kselect_streaming_many(chunks, ks, radix_bits=4, collect_budget=32, obs=o, devices=2, **CPU)
    off = kt.kselect_streaming_many(chunks, ks, radix_bits=4, collect_budget=32, devices=2, **CPU)
    with enable_x64():
        ref = ref_many(chunks, ks, radix_bits=4, collect_budget=32, obs=jo, devices=2)
    assert [np.float64(g).tobytes() for g in got] == [np.float64(g).tobytes() for g in off] == \
        [np.float64(g).tobytes() for g in ref]
    obs_lib.check_stream_invariants(o.events.events)
    assert all(len(e.survivors) == len(ks) for e in o.events.of_kind("stream.pass") if e.pass_index != "collect")
    assert _stream(o.events.events) == _stream(jo.events.events)
    assert {d["event"] for d in json.loads(json.dumps(_stream(o.events.events)))} == {"stream.pass", "stream.chunk"}
    for name in ("ingest.chunks", "ingest.bytes"):
        for slot in ("0", "1"):
            assert o.metrics.counter(name, labels={"device": slot}).value == \
                jo.metrics.counter(name, labels={"device": slot}).value > 0


def test_sketch_certificate_and_quantiles_events_match_jax(rng):
    """``sketch.pass`` (with its staged chunks), ``certificate.pass`` and a
    ``StreamingQuantiles`` flow (sketch, then the seeded descent) equal
    the JAX package's event for event."""
    from mpi_k_selection_tpu import StreamingQuantiles as JaxQuantiles
    from mpi_k_selection_tpu.streaming import RadixSketch as JaxSketch
    from mpi_k_selection_tpu.streaming.chunked import streaming_rank_certificate as ref_cert

    chunks = _chunks(rng, sizes=(3000, 2000, 1024))
    for devices in (None, 2):
        o, jo = obs_lib.Observability.collecting(), _jax_obs()
        sk = kt.RadixSketch(np.int32, device="cpu").update_stream(chunks, devices=devices, obs=o)
        jsk = JaxSketch(np.int32).update_stream(chunks, devices=devices, obs=jo)
        assert [h.tolist() for h in sk.hists] == [h.tolist() for h in jsk.hists]
        (ev,) = o.events.of_kind("sketch.pass")
        assert ev.chunks == 3 and ev.keys_read == 6024 and ev.staged_chunks == (0 if devices is None else 3)
        assert _stream(o.events.events) == _stream(jo.events.events)
        v = _oracle(chunks, 3012)
        o, jo = obs_lib.Observability.collecting(), _jax_obs()
        less, leq = kt.streaming_rank_certificate(chunks, v, devices=devices, obs=o, **CPU)
        assert (less, leq) == tuple(int(c) for c in ref_cert(chunks, v, devices=devices, obs=jo)) and less < 3012 <= leq
        assert _stream(o.events.events) == _stream(jo.events.events)
    o, jo = obs_lib.Observability.collecting(), _jax_obs()
    sq = kt.StreamingQuantiles(np.int32, obs=o, **CPU).update_stream(chunks)
    jsq = JaxQuantiles(np.int32, obs=jo).update_stream(chunks)
    assert sq.refine_quantiles([0.5, 0.9], chunks) == jsq.refine_quantiles([0.5, 0.9], chunks)
    assert o.events.of_kind("sketch.pass") and o.events.of_kind("stream.pass")
    assert _stream(o.events.events) == _stream(jo.events.events)


def test_resident_select_events_and_ledger_match_jax(rng):
    """``kselect`` and ``kselect_many`` emit one ``resident.select`` each,
    as the JAX package's; the ``api.select`` ledger site counts the first
    call of a key as its compile and the repeat as a hit, in both."""
    from mpi_k_selection_tpu import api as japi
    from mpi_k_selection_tpu.obs import LEDGER as JLEDGER
    from mpi_k_selection_tpu.obs import snapshot_delta as jdelta

    x = rng.integers(0, 1000, size=50021, dtype=np.int32)  # a size no other test selects
    ks = [100, 25000, 50000]
    o, jo = obs_lib.Observability.collecting(), _jax_obs()
    b, jb = obs_lib.LEDGER.snapshot(), JLEDGER.snapshot()
    for pkg, kw, run in ((o, CPU, kt), (jo, {}, japi)):
        assert int(run.kselect(x, 25000, obs=pkg, **kw)) == int(np.sort(x)[24999])
        assert int(run.kselect(x, 25000, obs=pkg, **kw)) == int(np.sort(x)[24999])
        got = run.kselect_many(x, ks, obs=pkg, **kw)
        assert [int(v) for v in got] == [int(np.sort(x)[k - 1]) for k in ks]
    assert _stream(o.events.events) == _stream(jo.events.events)
    ev = o.events.of_kind("resident.select")
    assert [(e.algorithm, e.queries, e.n, e.dtype) for e in ev] == [
        ("radix", 1, 50021, "int32"), ("radix", 1, 50021, "int32"), ("radix-many", 3, 50021, "int32")]
    mine = obs_lib.snapshot_delta(b, obs_lib.LEDGER.snapshot())["sites"]["api.select"]
    theirs = jdelta(jb, JLEDGER.snapshot())["sites"]["api.select"]
    assert (mine["compiles"], mine["hits"], mine["distinct_keys"]) == \
        (theirs["compiles"], theirs["hits"], theirs["distinct_keys"]) == (2, 1, 2)


def _distributed_events(mesh, x, k):
    from mpi_k_selection_tpu_torch import obs as lib
    from mpi_k_selection_tpu_torch.parallel import distributed_radix_select

    o = lib.Observability(events=lib.ListSink())
    v = distributed_radix_select(x, k, mesh=mesh, radix_bits=8, obs=o)
    return int(v), [e.as_dict() for e in o.events.events]


def test_distributed_select_event_matches_jax():
    """``distributed_radix_select(obs=)`` at world 2 over gloo emits the JAX
    package's ``distributed.select`` event on a 2-device mesh."""
    from mpi_k_selection_tpu.parallel import distributed_radix_select as ref
    from mpi_k_selection_tpu.parallel.mesh import make_mesh

    from mpi_k_selection_tpu_torch.parallel import run_ranks

    x = np.random.default_rng(5).integers(-(2**31), 2**31, size=65553, dtype=np.int64).astype(np.int32)
    k = 32000
    v, events = run_ranks(_distributed_events, 2, x, k, device="cpu")
    from mpi_k_selection_tpu import obs as jobs

    jo = jobs.Observability(events=jobs.ListSink())
    assert v == int(ref(x, k, mesh=make_mesh(2), radix_bits=8, obs=jo)) == int(np.sort(x)[k - 1])
    assert events == _stream(jo.events.events)
    assert events[0]["event"] == "distributed.select" and events[0]["n_devices"] == 2


def test_invariant_checker_catches_violations():
    """Every rule of ``check_stream_invariants`` fires on a stream that
    breaks it (the port's copy, against the JAX package's on each)."""
    from mpi_k_selection_tpu import obs as jobs

    def ev(lib, **kw):
        base = dict(pass_index=0, resolved_bits=0, prefixes=(), chunks=1, keys_read=100, bytes_read=400,
                    read_from="source", bucket_total=100, bucket_max=50, bucket_nonzero=3, survivors=(40,))
        base.update(kw)
        return lib.StreamPassEvent(**base)

    def chunk(lib, i, n, p=0):
        return lib.ChunkEvent(pass_index=p, chunk_index=i, n=n, nbytes=4 * n, device_slot=None, staged=False)

    cases = [
        ("no StreamPassEvent", lambda L: []),
        ("grew past", lambda L: [ev(L), ev(L, pass_index=1, prefixes=(3,), bucket_total=40, bucket_max=40,
                                          bucket_nonzero=1, survivors=(99,))]),
        ("strictly increasing", lambda L: [ev(L), ev(L)]),
        ("collect event is not last", lambda L: [ev(L, pass_index="collect", prefixes=(1,), survivors=(5,),
                                                      bucket_total=5, bucket_max=5), ev(L)]),
        ("!= keys_read", lambda L: [ev(L, bucket_total=99)]),
        ("chunk indices out of order", lambda L: [ev(L), chunk(L, 1, 100)]),
        ("chunk sizes sum", lambda L: [ev(L), chunk(L, 0, 60)]),
        ("never inflate", lambda L: [ev(L, keys_written=10, bytes_written=40, disk_bytes_written=41)]),
        ("empty spec population", lambda L: [ev(L, pass_index="collect", prefixes=(1,), survivors=(0,),
                                                bucket_total=0, bucket_max=0)]),
    ]
    for match, make in cases:
        for lib in (obs_lib, jobs):
            with pytest.raises(AssertionError, match=match):
                lib.check_stream_invariants(make(lib))
    for lib in (obs_lib, jobs):
        with pytest.raises(AssertionError, match="pass_log"):
            lib.check_stream_invariants([ev(lib)], spill_pass_log=[{"pass": 0, "bytes_read": 404}])
        lib.check_stream_invariants([ev(lib, chunks=2), chunk(lib, 0, 60), chunk(lib, 1, 40)],
                                    spill_pass_log=[{"pass": 0, "bytes_read": 400}])


def _seeded_registry(lib):
    reg = lib.MetricsRegistry()
    reg.counter("ingest.chunks", labels={"device": "0"}).inc(3)
    reg.counter("ingest.chunks", labels={"device": "1"}).inc(2)
    reg.counter("ingest.bytes", labels={"device": "0"}).inc(12000)
    reg.gauge("stall.seconds").set(1.5)
    reg.gauge("phase.seconds", labels={"phase": 'a "quoted"\\phase'}).set(0.25)
    h = reg.histogram("inflight.occupancy", buckets=(1, 2, 4))
    for v in (0, 1, 2, 3, 9):
        h.observe(v)
    reg.enable_windowed("serve.latency_seconds", window=2, advance_every=4)
    w = reg.histogram("serve.latency_seconds", labels={"tier": "exact"}, buckets=(0.001, 0.01))
    for i in range(11):
        w.observe(0.0007 * (i % 5) + 0.0001 * i)
    return reg


def test_metrics_exposition_matches_jax():
    """A registry seeded with the same records renders the JAX package's
    Prometheus text and JSON, byte for byte (windowed quantiles too)."""
    from mpi_k_selection_tpu import obs as jobs

    mine, theirs = _seeded_registry(obs_lib), _seeded_registry(jobs)
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.to_json(indent=1) == theirs.to_json(indent=1)
    text = mine.render_prometheus()
    assert 'ksel_ingest_chunks{device="0"} 3' in text and "ksel_serve_latency_seconds_windowed" in text
    assert json.loads(mine.to_json())['ingest.chunks{device="1"}']["value"] == 2
    with pytest.raises(TypeError):
        mine.gauge("ingest.chunks", labels={"device": "0"})
    with pytest.raises(TypeError, match="enable_windowed"):
        mine.enable_windowed("inflight.occupancy")


def test_metrics_thread_safety_and_collect_runtime(rng, tmp_path):
    reg = obs_lib.MetricsRegistry()
    c, h = reg.counter("n"), reg.histogram("h")

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000 and h.count == 8000 and h.sum == 8000
    timer = PhaseTimer()
    timer.record("pipeline.stall", 0.125)
    with kt.SpillStore(str(tmp_path)) as store:
        chunks = _chunks(rng, sizes=(2048, 1024))
        kt.kselect_streaming(chunks, 1536, radix_bits=4, collect_budget=32, spill=store, **CPU)
        reg = obs_lib.MetricsRegistry()
        collect_runtime(reg, staging_pool=pl.STAGING_POOL, spill_store=store, timer=timer)
        log = list(store.pass_log)
        collect_runtime(reg, staging_pool=pl.STAGING_POOL, spill_store=store, timer=timer)  # idempotent
        assert reg.gauge("spill.generations_live").value == len(store.generations)
    assert reg.counter("spill.passes").value == len(log)
    assert reg.counter("spill.bytes_read").value == sum(p["bytes_read"] for p in log)
    assert reg.counter("spill.keys_written").value == sum(p.get("keys_written", 0) for p in log)
    assert reg.counter("staging_pool.misses").value == pl.STAGING_POOL.misses
    assert reg.gauge("phase.seconds", labels={"phase": "pipeline.stall"}).value == 0.125


def test_occupancy_and_bucket_reads_on_a_pipelined_run(rng):
    """The window holds one bundle a slot (occupancy at most 2 with two
    slots), and the port's one launch a chunk a pass reads each chunk
    once: ``ingest.bucket_reads`` equals the chunk events a phase."""
    chunks = [rng.integers(0, 2**31 - 1, size=2048, dtype=np.int32) for _ in range(6)]
    o = obs_lib.Observability.collecting()
    kt.kselect_streaming(chunks, 6144, pipeline_depth=2, devices=2, obs=o, **CPU)
    occ = o.metrics.histogram("inflight.occupancy")
    assert occ.count > 0 and 1 <= occ.max <= 2
    events = o.events.of_kind("stream.chunk")
    reads = {lab["phase"]: m.value for m in o.metrics.metrics() if m.name == "ingest.bucket_reads"
             for lab in [dict(m.labels)]}
    assert reads == {"histogram": sum(e.pass_index != "collect" for e in events),
                     "collect": sum(e.pass_index == "collect" for e in events)}
    assert o.metrics.counter("ingest.staged_bytes").value == 4 * sum(e.n for e in events if e.staged)
    led = dict(o.metrics.as_dict())
    assert any(k.startswith("ledger.compiles{site=\"ingest.histogram\"") for k in led)


def test_trace_recorder_cross_thread_chrome_export():
    rec = obs_lib.TraceRecorder()
    timer = PhaseTimer(recorder=rec)

    def producer():
        for _ in range(3):
            with timer.phase("pipeline.produce"):
                pass

    t = threading.Thread(target=producer, name="ksel-test-producer")
    with timer.phase("pipeline.stall"):
        t.start()
        t.join()
    assert len(rec.spans) == 4 and len(rec.thread_ids()) == 2
    trace = json.loads(rec.to_json())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    names = {m["args"]["name"] for m in trace["traceEvents"] if m["ph"] == "M"}
    assert len(xs) == 4 and len({e["tid"] for e in xs}) == 2 and "ksel-test-producer" in names
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs) and min(e["ts"] for e in xs) == 0


def test_streaming_trace_shows_producer_and_consumer_tracks(rng):
    chunks = _chunks(rng, sizes=(4096, 2048, 2048))
    o = obs_lib.Observability.collecting()
    kt.kselect_streaming(chunks, 4096, pipeline_depth=2, devices=2, obs=o, **CPU)
    xs = [e for e in o.trace.to_chrome_trace()["traceEvents"] if e["ph"] == "X"]
    by_tid = {}
    for e in xs:
        by_tid.setdefault(e["tid"], set()).add(e["name"])
    assert len(by_tid) >= 2
    producer = set().union(*(v for v in by_tid.values() if "pipeline.produce" in v))
    consumer = set().union(*(v for v in by_tid.values() if "descent.pass" in v))
    assert {"pipeline.encode", "pipeline.stage"} <= producer and "pipeline.stall" in consumer


def test_phase_timer_concurrency_and_nesting():
    timer = PhaseTimer()

    def work():
        for _ in range(400):
            with timer.phase("shared"):
                pass
            timer.record("recorded", 0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timer.counts["shared"] == timer.counts["recorded"] == 3200
    assert timer.phases["recorded"] == pytest.approx(3.2)
    assert timer.as_dict()["shared"]["calls"] == 3200 and "total" in timer.report()
    rec = obs_lib.TraceRecorder()
    nested = PhaseTimer(recorder=rec)
    with nested.phase("outer"):
        with nested.phase("inner"):
            pass
        with nested.phase("inner", args={"id": 1}):
            pass
    assert nested.counts == {"inner": 2, "outer": 1}
    outer = next(s for s in rec.spans if s.name == "outer")
    assert all(outer.t0 <= s.t0 <= s.t1 <= outer.t1 for s in rec.spans if s.name == "inner")
    assert [s.args for s in rec.spans if s.name == "inner"] == [None, {"id": 1}]


def test_recorder_detached_and_channels_independent(rng):
    """An instrumented call attaches the trace recorder to a caller's timer
    only for its own duration; a metrics-only or events-only bundle
    works alone."""
    chunks = _chunks(rng, sizes=(2048, 1024))
    timer = PhaseTimer()
    o = obs_lib.Observability.collecting()
    kt.kselect_streaming(chunks, 17, timer=timer, obs=o, **CPU)
    assert timer.recorder is None and len(o.trace.spans) > 0
    n_spans = len(o.trace.spans)
    kt.kselect_streaming(chunks, 17, timer=timer, **CPU)
    assert len(o.trace.spans) == n_spans
    rec = obs_lib.TraceRecorder()
    timer2 = PhaseTimer(recorder=rec)
    kt.kselect_streaming(chunks, 17, timer=timer2, obs=o, **CPU)
    assert timer2.recorder is rec
    m = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
    assert kt.kselect_streaming(chunks, 17, obs=m, **CPU) == _oracle(chunks, 17)
    assert m.events is None and m.trace is None and m.metrics.as_dict()
    e = obs_lib.Observability(events=obs_lib.ListSink())
    kt.kselect_streaming(chunks, 17, obs=e, **CPU)
    assert len(e.events) > 0
    seen = []
    kt.kselect_streaming(chunks, 17, obs=obs_lib.Observability(events=obs_lib.CallbackSink(seen.append)), **CPU)
    assert [x.as_dict() for x in seen] == [x.as_dict() for x in e.events.events]


def test_program_ledger_books_and_storms_match_jax():
    """A private ledger of each package, fed the same dispatches: the same
    compile/hit/recompile books, storm events, byte gauges and
    ``ledger.*`` metrics."""
    from mpi_k_selection_tpu import obs as jobs

    out = []
    for lib in (obs_lib, jobs):
        led = lib.ProgramLedger(storm_threshold=2)
        o = lib.Observability(events=lib.ListSink())
        for key in ((1,), (2,), (1,), (3,), (4,)):
            with lib.ledger_dispatch("site", key, o, ledger=led):
                pass
        led.adjust_bytes("staging", "cuda:0", 100)
        led.adjust_bytes("staging", "cuda:0", -100)
        led.set_bytes("staging_pool", None, 64)
        snap = led.snapshot()
        for site in snap["sites"].values():
            site.pop("compile_seconds", None)
        reg = lib.collect_ledger(lib.MetricsRegistry(), ledger=led)
        names = sorted(k for k in reg.as_dict() if "compile_seconds" not in k)
        out.append((snap, [e.as_dict() for e in o.events.events], names,
                    lib.snapshot_delta(lib.ProgramLedger().snapshot(), snap)["compiles"]))
    assert out[0] == out[1]
    assert out[0][0]["sites"]["site"] == {"compiles": 4, "hits": 1, "recompiles": 2, "distinct_keys": 4}


def test_flight_refused_and_profiling_surfaces(tmp_path):
    """``flight=`` is taken in every form the JAX package takes (True, an
    int ring capacity, a FlightRecorder) and refused in the others with its
    message; the profiler writes its Chrome trace into the directory; no
    card, no memory rows."""
    from mpi_k_selection_tpu import obs as jobs

    for make in (lambda lib, f: lib.Observability(flight=f), lambda lib, f: lib.Observability.collecting(flight=f)):
        assert isinstance(make(obs_lib, True).flight, obs_lib.FlightRecorder)
        assert make(obs_lib, 7).flight._events.maxlen == make(jobs, 7).flight._events.maxlen == 7
        rec = obs_lib.FlightRecorder(dump_dir=tmp_path)
        assert make(obs_lib, rec).flight is rec
        said = []
        for lib in (obs_lib, jobs):
            with pytest.raises(ValueError) as ei:
                make(lib, "yes")
            said.append(str(ei.value))
        assert said[0] == said[1]
    assert obs_lib.Observability(flight=None).flight is None and obs_lib.Observability(flight=False).flight is None
    assert obs_lib.Observability.collecting().flight is None
    from mpi_k_selection_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "tr")):
        torch.arange(1000).sum()
    (name,) = os.listdir(tmp_path / "tr")
    assert json.load(open(tmp_path / "tr" / name))["traceEvents"]
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == []


def test_monitor_obs_matches_jax(rng):
    """``Monitor(obs=)``: the samples, the ``monitor.*`` series and the
    chunk events equal the JAX package's."""
    from mpi_k_selection_tpu.monitor import Monitor as JaxMonitor

    chunks = [rng.integers(0, 1 << 20, size=256, dtype=np.int32) for _ in range(10)]
    o, jo = obs_lib.Observability.collecting(), _jax_obs()
    mine = [s.as_dict() for s in kt.Monitor(window=4, emit_every=2, obs=o, **CPU).run(chunks, np.int32)]
    theirs = [s.as_dict() for s in JaxMonitor(window=4, emit_every=2, obs=jo).run(chunks, np.int32)]
    assert mine == theirs
    pick = lambda reg: {k: v for k, v in reg.as_dict().items() if k.startswith("monitor.")}  # noqa: E731
    assert pick(o.metrics) == pick(jo.metrics) and o.metrics.counter("monitor.samples").value == 5
    assert _stream(o.events.events) == _stream(jo.events.events)
    two = [s.as_dict() for s in kt.Monitor(window=4, emit_every=2, devices=2, pipeline_depth=2, **CPU)
           .run(chunks, np.int32)]
    assert two == mine


def test_cli_metrics_json_trace_events_and_profile(tmp_path, capsys):
    from mpi_k_selection_tpu_torch import cli

    mpath, tpath = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    args = ["--streaming", "--n", "40000", "--chunk-elems", "9973", "--check", "--json", "--device", "cpu",
            "--devices", "2", "--metrics-json", mpath, "--trace-events", tpath, "--profile",
            "--trace-dir", str(tmp_path / "prof")]
    assert cli.main(args) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["extra"]["certificate_ok"] and "pipeline_phases" in rec["extra"] and "solve" in rec["extra"]["phases"]
    metrics = json.load(open(mpath))
    # 5 chunks a pass, round robin: slot 0 takes chunks 0, 2 and 4
    assert metrics['ingest.chunks{device="0"}']["value"] > metrics['ingest.chunks{device="1"}']["value"] > 0
    assert metrics["run.repeats"]["value"] == 1 and 'phase.seconds{phase="solve"}' in metrics
    names = {e["name"] for e in json.load(open(tpath))["traceEvents"]}
    assert {"solve", "descent.pass", "pipeline.produce", "certificate.pass"} <= names
    assert os.listdir(tmp_path / "prof")
    assert cli.main(["--n", "20000", "--device", "cpu", "--json", "--metrics-json", mpath, "--check"]) == 0
    assert 'phase.seconds{phase="generate"}' in json.load(open(mpath))


def _bundle_ok(path, reason):
    """A bundle on disk parses, carries the five sections, and names its
    reason (the conftest validates only the JAX package's bundles)."""
    bundle = json.load(open(path))
    assert set(obs_lib.flight.BUNDLE_SECTIONS) <= set(bundle) and bundle["reason"] == reason
    return bundle


def test_flight_ring_bundle_sections_match_jax(rng, tmp_path):
    """The ring keeps the newest ``capacity`` events and spans (from the
    producer's thread and the consumer's), and a bundle's sections hold the
    same keys as the JAX package's bundle, its events the same dicts for
    the same events; the lock-order section is None in the port."""
    from mpi_k_selection_tpu import obs as jobs

    rec = obs_lib.FlightRecorder(capacity=4, span_capacity=64, dump_dir=tmp_path)
    o = obs_lib.Observability(events=obs_lib.ListSink(), metrics=obs_lib.MetricsRegistry(), flight=rec)
    chunks = _chunks(rng)
    got = kt.kselect_streaming(chunks, 9000, pipeline_depth=2, radix_bits=4, collect_budget=64, obs=o, **CPU)
    assert got == kt.kselect_streaming(chunks, 9000, pipeline_depth=2, radix_bits=4, collect_budget=64, **CPU)
    assert rec.events_tail() == o.events.events[-4:]  # the newest four, in order
    threads = {t for *_, t, _ in rec.spans_tail()}
    assert len(threads) >= 2 and any(t.startswith("ksel-pipeline") for t in threads)
    mine = rec.bundle(obs=o, reason="test")
    jrec = jobs.FlightRecorder(capacity=4)
    jo = jobs.Observability(metrics=jobs.MetricsRegistry(), flight=jrec)
    for e in rec.events_tail():
        jo.emit(getattr(jobs, type(e).__name__)(**{f.name: getattr(e, f.name) for f in dataclasses.fields(e)}))
    jrec.record("descent.pass", 1.0, 2.0)
    theirs = jrec.bundle(obs=jo, reason="test")
    assert set(mine) == set(theirs) and mine["events"] == theirs["events"]
    assert set(mine["spans"]) == set(theirs["spans"]) and set(mine["spans"]["tail"][0]) == set(
        theirs["spans"]["tail"][0])
    assert set(mine["faults"]) == set(theirs["faults"]) and mine["lock_order"] is None
    assert mine["metrics"] and "ingest.chunks" in json.dumps(mine["metrics"])
    path = rec.dump(tmp_path / "on-demand.json", obs=o)
    _bundle_ok(path, "on-demand")
    assert path in obs_lib.flight.drain_dumped() and obs_lib.flight.drain_dumped() == []
    os.unlink(path)
    assert os.listdir(tmp_path) == []


def test_flight_auto_dump_once_and_never_raises(tmp_path):
    """One automatic dump per recorder; a failed write raises from
    ``maybe_auto_dump`` but does not use the dump up, and the ``auto_dump``
    hook never raises (and does nothing without a flight channel)."""
    from mpi_k_selection_tpu_torch.obs.flight import auto_dump

    missing = tmp_path / "missing"
    rec = obs_lib.FlightRecorder(dump_dir=missing)
    o = obs_lib.Observability(flight=rec)
    assert auto_dump(o, "retry-exhausted", exc=RuntimeError("x")) is None  # the dir is missing: swallowed
    with pytest.raises(OSError):
        rec.maybe_auto_dump("retry-exhausted")
    missing.mkdir()
    first = auto_dump(o, "retry-exhausted", exc=RuntimeError("boom"))
    assert first is not None and auto_dump(o, "retry-exhausted") is None and rec.auto_dumps == [first]
    bundle = _bundle_ok(first, "retry-exhausted")
    assert bundle["error"] == "RuntimeError: boom" and os.path.basename(first).startswith("ksel-flight-")
    assert auto_dump(None, "x") is None and auto_dump(obs_lib.Observability(), "x") is None
    obs_lib.flight.drain_dumped()
    os.unlink(first)
    assert os.listdir(missing) == []


def test_cli_debug_bundle_on_success_and_on_error(tmp_path, capsys):
    """``--debug-bundle PATH`` writes the bundle at exit, success or
    failure; a chaos run's bundle holds the injected and recovered faults."""
    from mpi_k_selection_tpu_torch import cli

    path = str(tmp_path / "b.json")
    argv = ["--streaming", "--n", "40000", "--chunk-elems", "8192", "--device", "cpu", "--json", "--spill", "force",
            "--spill-dir", str(tmp_path), "--chaos", "7", "--check", "--debug-bundle", path]
    assert cli.main(argv) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["extra"]["debug_bundle"] == path and rec["extra"]["certificate_ok"]
    bundle = _bundle_ok(path, "cli")
    actions = [e["action"] for e in bundle["faults"]["events"]]
    assert actions.count("inject") == len(rec["extra"]["chaos"]["fired"]) and "rebuild" in actions
    bad = str(tmp_path / "bad.json")
    with pytest.raises(SystemExit, match="error"):
        cli.main(["--streaming", "--n", "40000", "--chunk-elems", "8192", "--device", "cpu", "--k", "0",
                  "--debug-bundle", bad])
    with pytest.raises(SystemExit, match="injected transient fault"):
        cli.main(["--streaming", "--n", "40000", "--chunk-elems", "8192", "--device", "cpu", "--chaos", "0",
                  "--retry", "off", "--debug-bundle", bad])
    assert _bundle_ok(bad, "cli-error")["error"].startswith("TransientError: injected transient fault")
    obs_lib.flight.drain_dumped()
    assert sorted(os.listdir(tmp_path)) == ["b.json", "bad.json"]


@pytest.mark.gpu
def test_obs_bit_identical_on_card(cuda_device, rng):  # noqa: F811
    """On the card, two slots on ``cuda:0`` with every channel on: the
    answers equal the plain run's and the CPU's, the stream holds its
    invariants and equals the CPU run's events."""
    chunks = _chunks(rng, sizes=(1 << 18, 1 << 17, 99991, 1 << 18))
    n = sum(c.size for c in chunks)
    ks = [1, n // 2, n]
    o, oc = obs_lib.Observability.collecting(), obs_lib.Observability.collecting()
    devs = ("cuda:0", "cuda:0")
    got = kt.kselect_streaming_many(chunks, ks, radix_bits=4, collect_budget=64, devices=devs, obs=o)
    plain = kt.kselect_streaming_many(chunks, ks, radix_bits=4, collect_budget=64, devices=devs)
    cpu = kt.kselect_streaming_many(chunks, ks, radix_bits=4, collect_budget=64, devices=2, obs=oc, **CPU)
    assert got == plain == cpu
    obs_lib.check_stream_invariants(o.events.events)
    strip = lambda ev: [{k: v for k, v in e.items() if k != "device_slot"} for e in _stream(ev)]  # noqa: E731
    assert strip(o.events.events) == strip(oc.events.events)
    assert {c.device_slot for c in o.events.of_kind("stream.chunk") if c.staged} == {0}
