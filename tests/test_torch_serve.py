"""The port's resident-dataset query server (``mpi_k_selection_tpu_torch/
serve/``) against the JAX package's (tests/test_serve.py) on the CPU.

The same seeded arrays and chunks go to both servers. Every answer is
compared field for field (value bits and dtype, bounds, tier, ``exact``,
``escalated``) with the JAX server's ``RankAnswer`` and, on the exact and
auto tiers, with serial JAX ``api.kselect``: across ``fast_path`` x
``warmup`` x tier x residency (device, stream) x window {0, 0.002} with 8
concurrent clients, across every dtype on the exact tier (both legs: the
cached sort, in ``lax.sort``'s order, and the walk), for streams, caches,
events and metrics, the HTTP fronts and the CLIs. The port's datasets live
on ``device="cpu"`` here (its kernels' plain versions); 64-bit JAX
references run under ``enable_x64()`` in scope. The JAX package is
imported inside the tests, so the ``gpu`` tests collect where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_serve.py -m gpu
"""

from __future__ import annotations

import ast
import http.client
import json
import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from mpi_k_selection_tpu_torch import obs as obs_lib
from mpi_k_selection_tpu_torch.obs import ledger as ldg
from mpi_k_selection_tpu_torch.serve import (
    TIERS,
    DatasetExistsError,
    DatasetNotFoundError,
    KSelectServer,
    ProgramCache,
    QueryError,
    ServerClosedError,
    start_http_server,
)
from mpi_k_selection_tpu_torch.utils.timing import Deadline
from test_torch_streaming import DTYPES, cuda_device, stream  # noqa: F401 (cuda_device: a fixture)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
# > 2^14: single exact ranks take the shared radix walk
N_BIG = 40_000
X = np.random.default_rng(0).integers(-(2**31), 2**31 - 1, size=N_BIG, dtype=np.int32)
CHUNKS = [c.copy() for c in np.array_split(X, 5)]
CLIENTS = 8
CLIENT_KS = [[1 + (i * 977 + j * 131) % N_BIG for j in range(3)] for i in range(CLIENTS)]
GRID_QS = [0.25, 0.9]


def _b(v):
    """A value as (dtype name, bytes): the bit-exact comparison key."""
    v = np.asarray(v)
    return str(v.dtype), v.tobytes()


def _fields(a):
    """Every field of a RankAnswer of either package, values as bits."""
    vb = None if a.value_bounds is None else tuple(_b(v) for v in a.value_bounds)
    return (a.k, _b(a.value), a.tier, a.exact, a.rank_bounds, vb, a.rank_error_bound, a.escalated)


def _jax_server(**kw):
    from mpi_k_selection_tpu.serve import KSelectServer as JaxServer

    return JaxServer(**kw)


def _http(port, method, path, body=None, trace_id=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        headers = {"Content-Type": "application/json"}
        if trace_id is not None:
            headers["X-Ksel-Trace-Id"] = trace_id
        c.request(method, path, None if body is None else json.dumps(body), headers)
        r = c.getresponse()
        return r.status, {k: v for k, v in r.getheaders() if k in ("Content-Type", "X-Ksel-Trace-Id", "Retry-After")}, \
            r.read()
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Deadline: the JAX package's interface


def test_deadline_matches_jax():
    """``Deadline(t1)`` at an instant, ``after(s)`` refusing s <= 0,
    ``remaining()`` clamped at 0.0 and ``expired``, as the JAX package's
    (no clock is read here)."""
    from mpi_k_selection_tpu.utils.timing import Deadline as JaxDeadline

    for cls in (Deadline, JaxDeadline):
        z = cls(0.0)  # a monotonic instant long past
        assert z.expired and z.remaining() == 0.0
        for bad in (0, -1, 0.0):
            with pytest.raises(ValueError, match="deadline must be > 0 seconds"):
                cls.after(bad)
        d = cls.after(30.0)
        assert not d.expired and 0.0 < d.remaining() <= 30.0
    assert Deadline.__slots__ == JaxDeadline.__slots__ == ("_t1",)


# ---------------------------------------------------------------------------
# registry lifecycle, validation


def test_registry_lifecycle_and_validation_match_jax():
    """The same registrations and bad queries raise the same error classes
    by name in both servers, and the listings are equal."""
    rows, raised = [], []
    for srv in (KSelectServer(), _jax_server()):
        kw = {"device": "cpu"} if isinstance(srv, KSelectServer) else {}
        got = []
        with srv:
            srv.add_dataset("a", X, **kw)
            srv.add_dataset("nosketch", X, sketch=False, **kw)
            for call in (
                lambda: srv.add_dataset("a", X, **kw),
                lambda: srv.kselect("missing", 1),
                lambda: srv.add_dataset("empty", np.empty(0, np.int32), **kw),
                lambda: srv.add_dataset("both", X, source=[X], **kw),
                lambda: srv.kselect("a", 0),
                lambda: srv.kselect("a", N_BIG + 1),
                lambda: srv.kselect("a", 1, tier="warp"),
                lambda: srv.quantiles("a", [1.5]),
                lambda: srv.kselect("nosketch", 1, tier="sketch"),
                lambda: srv.topk("a", 0),
                lambda: srv.drop_dataset("ghost"),
            ):
                with pytest.raises(Exception) as ei:
                    call()
                got.append((type(ei.value).__name__, str(ei.value)))
            a = srv.kselect("nosketch", 7, tier="auto")
            assert (a.tier, a.exact, a.escalated) == ("exact", True, True)
            rows.append(srv.list_datasets())
            srv.drop_dataset("nosketch")
            rows.append(srv.list_datasets())
        with pytest.raises(Exception) as ei:  # either package's ServerClosedError
            srv.kselect("a", 1, tier="sketch")
        got.append(type(ei.value).__name__)
        raised.append(got)
    assert raised[0] == raised[1]
    assert [g[0] for g in raised[0][:4]] == [
        DatasetExistsError.__name__, DatasetNotFoundError.__name__, QueryError.__name__, QueryError.__name__,
    ]
    assert raised[0][-1] == "ServerClosedError"
    assert rows[0] == rows[2] and rows[1] == rows[3]
    assert rows[0][0]["residency"] == "device" and rows[0][0]["sketch_resolution_bits"] == 16


# ---------------------------------------------------------------------------
# the determinism grid


@pytest.fixture(scope="module")
def jax_grid():
    """The JAX server's answer to every grid request, and serial JAX
    ``api.kselect`` of every rank the exact tiers answer."""
    from mpi_k_selection_tpu import api as japi

    want = {}
    with _jax_server() as js:
        js.add_dataset("dev", X)
        js.add_dataset("stream", source=CHUNKS)
        for d in ("dev", "stream"):
            for tier in TIERS:
                for i, ks in enumerate(CLIENT_KS):
                    want[d, tier, i] = [_fields(a) for a in js.kselect_many(d, ks, tier=tier)]
                want[d, tier, "q"] = [_fields(a) for a in js.quantiles(d, GRID_QS, tier=tier)]
    ranks = {k for ks in CLIENT_KS for k in ks} | set(japi.quantile_ranks(GRID_QS, N_BIG))
    serial = {k: _b(np.asarray(japi.kselect(X, k))) for k in ranks}
    return want, serial


@pytest.mark.parametrize("window", [0.0, 0.002])
@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("fast_path", [True, False])
def test_determinism_grid(jax_grid, fast_path, warmup, window):
    """8 concurrent clients send every tier's rank and quantile queries to a
    device and a stream dataset: every answer equals the JAX server's field
    for field, and every exact value serial JAX ``api.kselect``'s bits."""
    want, serial = jax_grid
    got, errors = {}, []
    with KSelectServer(window=window, fast_path=fast_path) as srv:
        srv.add_dataset("dev", X, device="cpu", warmup=warmup)
        srv.add_dataset("stream", source=CHUNKS, device="cpu", warmup=warmup)
        barrier = threading.Barrier(CLIENTS)

        def client(i):
            try:
                barrier.wait(timeout=30)
                for d in ("dev", "stream"):
                    for tier in TIERS:
                        got[d, tier, i] = [_fields(a) for a in srv.kselect_many(d, CLIENT_KS[i], tier=tier)]
                        if i % 4 == 0:
                            got[d, tier, "q"] = [_fields(a) for a in srv.quantiles(d, GRID_QS, tier=tier)]
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}") for i in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not errors, errors
    assert got == want
    for (d, tier, _), answers in got.items():
        if tier != "sketch":
            assert all(f[1] == serial[f[0]] for f in answers), (d, tier)


def test_fast_path_and_queued_oracle_route(rng):
    """``fast_path=True`` answers sketch and auto-pinned queries on the
    request thread (``serve.fastpath{tier=}``, no lane opened);
    ``fast_path=False`` routes them through the lane: the same fields, and
    the JAX server's."""
    x = rng.integers(-(2**15), 2**15 - 1, size=N_BIG).astype(np.int16)  # 16 bits: every rank pins
    answers = []
    for fast in (True, False):
        o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
        with KSelectServer(obs=o, fast_path=fast) as srv:
            srv.add_dataset("a", x, device="cpu")
            answers.append([_fields(srv.kselect("a", 5, tier=t)) for t in ("sketch", "auto")])
            fastpath = [o.metrics.counter("serve.fastpath", labels={"tier": t}).value for t in ("sketch", "auto")]
            summary = srv.batcher.lane_summary()
        if fast:
            assert fastpath == [1, 1] and summary == {}
        else:
            assert fastpath == [0, 0] and sum(s["submitted"] for s in summary.values()) == 2
    with _jax_server() as js:
        js.add_dataset("a", x)
        answers.append([_fields(js.kselect("a", 5, tier=t)) for t in ("sketch", "auto")])
    assert answers[0] == answers[1] == answers[2]
    assert answers[0][1][2:4] == ("sketch", True)


# ---------------------------------------------------------------------------
# the exact tier across dtypes


def _np(name, x):
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    return np.asarray(x, numpy_dtype(name))


@pytest.mark.parametrize("name", DTYPES)
def test_exact_tier_across_dtypes(name):
    """Every dtype, with ties (and +-0.0, +-inf and NaNs of both signs for
    floats): the cached sort (n <= 2^14) answers in ``lax.sort``'s order and
    the walk (n > 2^14) in key order, each equal to serial JAX
    ``api.kselect`` and, for dtypes of 32 bits or fewer, to the JAX
    server's exact answers field for field."""
    from mpi_k_selection_tpu import api as japi
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    small = np.concatenate(stream(name, seed=3))
    large = np.concatenate(stream(name, seed=4, sizes=(9000, 11000)))
    for x in (small, large):
        n = x.size
        ks = [1, 2, n // 3, n // 2, n - 1, n]
        with KSelectServer() as srv:
            srv.add_dataset("d", x, device="cpu", sketch=False)
            got = [_fields(a) for a in srv.kselect_many("d", ks, tier="exact")]
            one = [_fields(srv.kselect("d", k, tier="exact")) for k in ks]
        assert got == one
        with enable_x64():
            want = [_b(np.asarray(japi.kselect(x, k))) for k in ks]
        assert [f[1] for f in got] == want, name
        if x.dtype.itemsize <= 4:
            with _jax_server() as js:
                js.add_dataset("d", x, sketch=False)
                assert [_fields(a) for a in js.kselect_many("d", ks, tier="exact")] == got


@pytest.mark.parametrize("n", [3000, N_BIG])
def test_float32_specials_on_the_sort_leg(n):
    """A float32 set of +-0.0 and NaNs of both signs: at n <= 2^14 and at
    K >= ``many_sort_dispatch_queries(n)`` the server takes its cached sort,
    which must return each zero and NaN with its own bits in ``lax.sort``'s
    order, as the JAX server and JAX ``api.kselect_many`` do."""
    from mpi_k_selection_tpu import api as japi

    from mpi_k_selection_tpu_torch.api import many_sort_dispatch_queries

    rng = np.random.default_rng(11)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf], np.float32), size=n)
    u = x.view(np.uint32)
    pos = rng.choice(n, size=40, replace=False)
    u[pos[:20]] = 0x7FC00000
    u[pos[20:]] = 0xFFC00001
    width = max(8, many_sort_dispatch_queries(n) + 3) if n > 1 << 14 else 8
    ks = sorted(set(np.linspace(1, n, width).astype(int).tolist()))
    with KSelectServer() as srv:
        srv.add_dataset("f", x, device="cpu", sketch=False)
        got = [_fields(a) for a in srv.kselect_many("f", ks, tier="exact")]
        assert ("sorted", "f") in srv.registry.programs._entries
    with _jax_server() as js:
        js.add_dataset("f", x, sketch=False)
        assert [_fields(a) for a in js.kselect_many("f", ks, tier="exact")] == got
    assert [f[1] for f in got] == [_b(v) for v in np.asarray(japi.kselect_many(x, ks))]
    kinds = {f[1][1] for f in got}
    assert len(kinds) >= 4  # zeros of both signs and NaN payloads come back as they were


def test_int64_answers_through_the_walk_with_the_jax_stream_route_bits(rng):
    """The port keeps caller-typed 64-bit integers resident (``device``);
    the JAX server without x64 sends them through its one-chunk stream
    route. The answers are the same bits."""
    x = rng.integers(-(2**62), 2**62, size=30000, dtype=np.int64)
    u = rng.integers(0, 2**63, size=3000, dtype=np.uint64)
    ks = [1, 1500, 3000]
    with KSelectServer() as srv, _jax_server() as js:
        for name, arr in (("wide", x), ("u64", u)):
            srv.add_dataset(name, arr, device="cpu")
            js.add_dataset(name, arr)
            assert (srv.registry.get(name).residency, js.registry.get(name).residency) == ("device", "stream")
            mine = [_fields(a) for a in srv.kselect_many(name, ks, tier="exact")]
            assert mine == [_fields(a) for a in js.kselect_many(name, ks, tier="exact")]
            assert [f[1] for f in mine] == [_b(v) for v in np.sort(arr, kind="stable")[np.asarray(ks) - 1]]
            assert _fields(srv.kselect(name, 1500, tier="sketch")) == _fields(js.kselect(name, 1500, tier="sketch"))


# ---------------------------------------------------------------------------
# streams and caches


def test_stream_dataset_matches_jax():
    """A stream dataset from chunks: the same n, sketch, exact quantiles,
    certificate and topk refusal as the JAX server's; a repeat shape hits
    the cached select; the descents run on the dataset's device."""
    qs = [0.1, 0.5, 0.99]
    out = []
    for srv in (KSelectServer(window=0.05), _jax_server(window=0.05)):
        kw = {"device": "cpu"} if isinstance(srv, KSelectServer) else {}
        with srv:
            ds = srv.add_dataset("st", source=CHUNKS, pipeline_depth=0, **kw)
            assert ds.residency == "stream" and ds.n == N_BIG and ds.nbytes == 0
            got = [_fields(a) for a in srv.quantiles("st", qs, tier="exact")]
            hits = srv.registry.programs.hits
            srv.quantiles("st", qs, tier="exact")
            assert srv.registry.programs.hits == hits + 1
            with pytest.raises(Exception, match="stream-resident"):
                srv.topk("st", 4)
            cert = srv.rank_certificate("st", np.sort(X)[99])
            out.append((got, cert, srv.list_datasets()))
    assert out[0] == out[1]
    assert out[0][1][0] < 100 <= out[0][1][1]
    assert out[0][0][1][1] == _b(np.sort(X)[N_BIG // 2 - 1])


def test_stream_knobs_refused_at_registration():
    """The JAX package's ``fused``, ``deferred`` and ``hist_method`` have no
    counterpart: refused when the stream is registered, saying why, before
    any pass; the knobs the port takes are kept for the descents."""
    with KSelectServer() as srv:
        for knob in ("fused", "deferred", "hist_method"):
            with pytest.raises(TypeError, match=f"add_stream\\(\\) got an unexpected keyword argument '{knob}': "
                                                "no counterpart"):
                srv.add_dataset("st", source=CHUNKS, device="cpu", **{knob: None})
        ds = srv.add_dataset("st", source=CHUNKS, device="cpu", pipeline_depth=2, width_schedule="auto")
        assert ds.stream_kwargs == {"pipeline_depth": 2, "width_schedule": "auto"}
        assert _b(srv.kselect("st", 777, tier="exact").value) == _b(np.sort(X)[776])


def test_program_cache_counters_and_ledger_book_match_jax():
    """The cache's hits and misses, their metric mirror and the ledger's
    ``serve.programs`` book move as the JAX package's over the same
    queries; dropping a dataset evicts its programs."""
    from mpi_k_selection_tpu.obs import ledger as jldg

    from mpi_k_selection_tpu_torch.api import many_sort_dispatch_queries

    wide = list(range(1, many_sort_dispatch_queries(N_BIG) + 2))
    trails = []
    for srv, book in ((KSelectServer(obs=obs_lib.Observability.collecting()), ldg),
                      (_jax_server(obs=_jax_collecting()), jldg)):
        kw = {"device": "cpu"} if isinstance(srv, KSelectServer) else {}
        trail = []
        with srv:
            srv.add_dataset("a", X, **kw)
            before = book.LEDGER.snapshot()
            for q in ([100], [31_337], [7], [5, 6], [9, 12], wide, wide):
                srv.kselect_many("a", q, tier="exact")
                trail.append((srv.registry.programs.misses, srv.registry.programs.hits))
            site = book.snapshot_delta(before, book.LEDGER.snapshot())["sites"]["serve.programs"]
            trail.append((site["compiles"], site["hits"]))
            snap = srv.collect_metrics().as_dict()
            trail.append((snap["serve.program_cache.hits"]["value"], snap["serve.program_cache.misses"]["value"],
                          snap["serve.program_cache.entries"]["value"]))
            srv.drop_dataset("a")
            trail.append(len(srv.registry.programs))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][:3] == [(1, 0), (1, 1), (1, 2)] and trails[0][-1] == 0


def _jax_collecting():
    from mpi_k_selection_tpu import obs as jobs

    return jobs.Observability.collecting()


def test_program_cache_lru_and_latch():
    """LRU eviction, and the per-key build latch: two racing first callers
    build once (the waiter a hit, one ledger compile); a failed build
    caches nothing and its waiter builds again."""
    cache = ProgramCache(max_entries=2)
    assert cache.get_or_build(("a", "d1"), lambda: 1) == 1
    assert cache.get_or_build(("b", "d1"), lambda: 2) == 2
    assert cache.get_or_build(("a", "d1"), lambda: 99) == 1
    cache.get_or_build(("c", "d1"), lambda: 3)  # evicts ("b", "d1")
    assert cache.get_or_build(("b", "d1"), lambda: 4) == 4
    assert (cache.hits, cache.misses) == (1, 4)

    for fail_first in (False, True):
        pc = ProgramCache()
        key = ("walk", f"latch-{fail_first}")
        before = ldg.LEDGER.snapshot()
        started, release, builds, results = threading.Event(), threading.Event(), [], []

        def builder():
            builds.append(1)
            started.set()
            assert release.wait(10)
            if fail_first and len(builds) == 1:
                raise RuntimeError("first build fails")
            return "program"

        def call():
            try:
                results.append(pc.get_or_build(key, builder))
            except RuntimeError as e:
                results.append(type(e).__name__)

        t1 = threading.Thread(target=call)
        t1.start()
        assert started.wait(10)
        t2 = threading.Thread(target=call)
        t2.start()
        t2.join(timeout=0.2)
        assert t2.is_alive() and len(builds) == 1  # parked on the latch
        release.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        book = ldg.snapshot_delta(before, ldg.LEDGER.snapshot())["sites"]["serve.programs"]
        if fail_first:
            assert sorted(results) == ["RuntimeError", "program"] and len(builds) == 2
            assert (pc.misses, pc.hits) == (2, 0) and book["compiles"] == 2
        else:
            assert results == ["program", "program"] and len(builds) == 1
            assert (pc.misses, pc.hits) == (1, 1) and (book["compiles"], book["hits"]) == (1, 1)


def test_warmup_gives_zero_compiles_on_the_request_path():
    """A warmed dataset's steady query mix (narrow exact ranks on the walk,
    a wide quantile batch on the cached sort, sketch and auto reads) books
    no build at ``serve.programs``, as the JAX package's; a cold one books
    its first build on the request path; warmup again builds nothing. The
    small and stream datasets warm what their queries reach."""
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu.obs import ledger as jldg

    counts = []
    for srv, book, o in ((KSelectServer, ldg, obs_lib.Observability(metrics=obs_lib.MetricsRegistry())),
                         (_jax_server, jldg, jobs.Observability(metrics=jobs.MetricsRegistry()))):
        kw = {"device": "cpu"} if srv is KSelectServer else {}
        with srv(obs=o) as s:
            s.add_dataset("a", X, warmup=True, **kw)
            s.add_dataset("small", X[:4096], warmup=True, **kw)
            s.add_dataset("st", source=CHUNKS, warmup=True, **kw)
            before = book.LEDGER.snapshot()
            for k in (5, 17, 31_337):
                s.kselect("a", k, tier="exact")
            s.quantiles("a", [i / 256 for i in range(1, 256)], tier="exact")
            s.kselect("a", 9, tier="sketch")
            s.kselect("a", 9, tier="auto")
            s.kselect("small", 1000, tier="exact")
            s.kselect("st", 1000, tier="exact")
            warm = book.snapshot_delta(before, book.LEDGER.snapshot())["sites"]["serve.programs"]
            again = s.registry.warmup(s.registry.get("a"))
            entries = sorted(k for k in s.registry.programs._entries)
            s.add_dataset("cold", X, **kw)
            before = book.LEDGER.snapshot()
            s.kselect("cold", 17, tier="exact")
            cold = book.snapshot_delta(before, book.LEDGER.snapshot())["sites"]["serve.programs"]
            counts.append((warm["compiles"], warm["hits"], again, entries, cold["compiles"],
                           o.metrics.counter("serve.warmup_compiles").value))
    assert counts[0] == counts[1]
    assert counts[0][0] == 0 and counts[0][2] == 0 and counts[0][4] == 1 and counts[0][5] == 4
    assert ("walk", "small") not in counts[0][3]


# ---------------------------------------------------------------------------
# events and metrics


def _serve_events(o):
    return [e.as_dict() for e in o.events.events if e.kind in ("serve.query", "serve.batch")]


def _prometheus(text):
    """The ``ksel_serve_*`` series as {series: value}, lane names (a
    deliberate difference: the port's device strings) replaced by one."""
    out = {}
    for line in text.splitlines():
        if line.startswith("ksel_serve_"):
            series, value = line.rsplit(" ", 1)
            out[re.sub(r'lane="[^"]*"', 'lane="<lane>"', series)] = float(value)
    return out


def test_events_and_prometheus_match_jax():
    """At window 0 with explicit trace ids, the ``serve.query`` and
    ``serve.batch`` event streams equal the JAX server's entry for entry;
    the ``ksel_serve_*`` Prometheus series and their labels are the same,
    and so are the counter and gauge values (latencies aside)."""
    streams, series = [], []
    for srv, o in ((KSelectServer, obs_lib.Observability.collecting()), (_jax_server, _jax_collecting())):
        kw = {"device": "cpu"} if srv is KSelectServer else {}
        with srv(obs=o) as s:
            s.add_dataset("a", X, **kw)
            s.kselect("a", 5, tier="exact", trace_id="t1")
            s.kselect("a", 5, tier="sketch", trace_id="t2")
            s.quantiles("a", [0.5, 0.9], tier="auto", trace_id="t3")
            s.kselect_many("a", [1, 2, 3], tier="exact", trace_id="t4")
            s.topk("a", 3, trace_id="t5")
            s.rank_certificate("a", 0, trace_id="t6")
            text = s.render_prometheus()
        streams.append(_serve_events(o))
        series.append(_prometheus(text))
    assert streams[0] == streams[1] and len(streams[0]) == 9
    assert set(series[0]) == set(series[1])
    steady = [k for k in series[0] if "latency" not in k]
    assert steady and {k: series[0][k] for k in steady} == {k: series[1][k] for k in steady}
    assert series[0]['ksel_serve_queries{op="kselect",tier="exact"}'] == 2


def test_obs_never_changes_answers_and_closed_server():
    """Answers with and without telemetry are the same bits; a closed
    server refuses every tier with ServerClosedError and closes twice."""
    ks = [3, 777, N_BIG]
    with KSelectServer() as srv:
        srv.add_dataset("a", X, device="cpu")
        plain = [_fields(a) for a in srv.kselect_many("a", ks, tier="exact")]
    srv2 = KSelectServer(obs=obs_lib.Observability.collecting(), window=0.05)
    srv2.add_dataset("a", X, device="cpu")
    assert [_fields(a) for a in srv2.kselect_many("a", ks, tier="exact")] == plain
    srv2.close()
    srv2.close()
    for tier in ("exact", "sketch"):
        with pytest.raises(ServerClosedError):
            srv2.kselect("a", 1, tier=tier)
    with pytest.raises(ServerClosedError):
        srv2.add_dataset("b", X, device="cpu")


# ---------------------------------------------------------------------------
# immutability and no fallback


def test_mutating_a_registered_array_changes_no_answer():
    """A CPU tensor and a NumPy array changed after registration leave every
    answer (exact, sketch, topk) as it was: the registration cloned them."""
    want = None
    for data in (torch.from_numpy(X.copy()), X.copy()):
        with KSelectServer() as srv:
            ds = srv.add_dataset("a", data, device="cpu")
            before = ([_fields(a) for a in srv.kselect_many("a", [1, 9, N_BIG // 2], tier="exact")],
                      _fields(srv.kselect("a", 9, tier="sketch")), srv.topk("a", 4)[0].tobytes())
            data[:] = 0
            after = ([_fields(a) for a in srv.kselect_many("a", [1, 9, N_BIG // 2], tier="exact")],
                     _fields(srv.kselect("a", 9, tier="sketch")), srv.topk("a", 4)[0].tobytes())
            assert ds.data.data_ptr() != (data.data_ptr() if isinstance(data, torch.Tensor)
                                          else data.__array_interface__["data"][0])
        assert before == after
        want = want or before
        assert before == want


def test_no_fallback_without_cuda():
    """Without a card, a dataset on the default device (``cuda``) is
    refused: an array, a stream, and the CLI's default ``--device``. No
    query is answered on the CPU in its place."""
    from mpi_k_selection_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device exists")

    with KSelectServer() as srv:
        with pytest.raises((AssertionError, RuntimeError)):
            srv.add_dataset("a", X)
        with pytest.raises((AssertionError, RuntimeError)):
            srv.add_dataset("s", source=CHUNKS)
        assert len(srv.registry) == 0
    with pytest.raises((AssertionError, RuntimeError, SystemExit)):
        cli.main(["serve", "--n", "64", "--port", "0", "--quit-after", "1"])


# ---------------------------------------------------------------------------
# the HTTP fronts


QUERY_BODIES = (
    {"dataset": "a", "op": "kselect", "k": 1234, "tier": "exact"},
    {"dataset": "a", "op": "kselect", "ks": [1, 2, N_BIG], "tier": "auto"},
    {"dataset": "a", "op": "quantiles", "qs": [0.5, 0.99], "tier": "sketch"},
    {"dataset": "a", "op": "topk", "k": 3},
    {"dataset": "a", "op": "topk", "k": 3, "largest": False},
    {"dataset": "a", "op": "rank_certificate", "value": 12345},
    {"dataset": "st", "op": "quantiles", "qs": [0.5], "tier": "exact"},
    {"dataset": "st", "op": "topk", "k": 3},
    {"dataset": "ghost", "op": "kselect", "k": 1},
    {"dataset": "a", "op": "warp"},
    {"dataset": "a", "op": "kselect"},
    {"dataset": "a", "op": "kselect", "k": 0},
    {"dataset": "a", "op": "quantiles"},
    {"dataset": "a", "op": "topk"},
    {"dataset": "a", "op": "rank_certificate"},
    {"op": "kselect", "k": 1},
    {"dataset": "a", "op": "kselect", "k": 3, "deadline_ms": -5},
    {"dataset": "a", "op": "kselect", "k": 3, "deadline_ms": True},
    {"dataset": "a", "op": "kselect", "k": 3, "deadline_ms": "soon"},
    {"dataset": "a", "op": "kselect", "k": 3, "deadline_ms": 60000},
)


def test_http_fronts_answer_alike():
    """The same requests to both HTTP fronts: the same status codes,
    headers (content type, the echoed trace id) and JSON bodies, for every
    op and tier, a stream dataset, and every malformed query; then the
    listing, health, metrics and debug-bundle endpoints, an unknown path,
    a bad body, and a closed server (503)."""
    from mpi_k_selection_tpu.serve import start_http_server as jax_start

    replies = []
    for srv, start in ((KSelectServer(window=0.01, obs=obs_lib.Observability.collecting(flight=True)),
                        start_http_server),
                       (_jax_server(window=0.01, obs=_jax_collecting(), flight=True), jax_start)):
        kw = {"device": "cpu"} if isinstance(srv, KSelectServer) else {}
        got = []
        with srv:
            srv.add_dataset("a", X, **kw)
            srv.add_dataset("st", source=CHUNKS, **kw)
            with start(srv) as h:
                for i, body in enumerate(QUERY_BODIES):
                    got.append(_http(h.port, "POST", "/v1/query", body, trace_id=f"req-{i}"))
                for path in ("/healthz", "/v1/datasets", "/nope"):
                    got.append(_http(h.port, "GET", path, trace_id="get"))
                status, headers, body = _http(h.port, "GET", "/metrics", trace_id="m")
                got.append((status, headers, b"ksel_serve_queries" in body and b"ksel_ledger_compiles" in body))
                status, headers, body = _http(h.port, "GET", "/debug/bundle", trace_id="b")
                got.append((status, headers, sorted(json.loads(body))))
                c = http.client.HTTPConnection("127.0.0.1", h.port, timeout=30)
                c.request("POST", "/v1/query", b"{not json", {"X-Ksel-Trace-Id": "bad", "Content-Length": "9"})
                r = c.getresponse()
                got.append((r.status, r.getheader("X-Ksel-Trace-Id"), json.loads(r.read())["error"][:12]))
                c.close()
                srv.close()
                got.append(_http(h.port, "POST", "/v1/query", QUERY_BODIES[0], trace_id="closed"))
        replies.append(got)
    assert replies[0] == replies[1]
    codes = [r[0] for r in replies[0][: len(QUERY_BODIES)]]
    assert codes == [200] * 7 + [400, 404] + [400] * 10 + [200]
    assert replies[0][-1][0] == 503


def test_http_concurrent_clients_bit_identical():
    ks = [1 + 313 * i for i in range(8)]
    want = [int(v) for v in np.sort(X)[np.asarray(ks) - 1]]
    with KSelectServer(window=0.2) as srv:
        srv.add_dataset("a", X, device="cpu")
        with start_http_server(srv) as h:
            results = [None] * len(ks)
            barrier = threading.Barrier(len(ks))

            def client(i):
                barrier.wait(timeout=30)
                status, _, body = _http(h.port, "POST", "/v1/query",
                                        {"dataset": "a", "op": "kselect", "k": ks[i], "tier": "exact"})
                assert status == 200
                results[i] = json.loads(body)["answers"][0]["value"]

            ts = [threading.Thread(target=client, args=(i,)) for i in range(len(ks))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    assert results == want


# ---------------------------------------------------------------------------
# the CLI


def _run_cli_serve(main, argv, tmp_path, requests):
    """Run ``main(["serve", *argv])`` on a thread and send it ``requests``
    (method, path, body); the replies and the exit code."""
    port_file = tmp_path / "port"
    rc, replies = [], []
    t = threading.Thread(target=lambda: rc.append(main(["serve", *argv, "--port", "0", "--port-file",
                                                         str(port_file), "--quit-after", str(len(requests))])),
                         name="cli-serve")
    t.start()
    for _ in range(1200):  # the listener comes up after the dataset is registered
        if port_file.exists() and port_file.read_text():
            break
        time.sleep(0.05)
    else:
        pytest.fail("serve CLI never wrote its port file")
    port = int(port_file.read_text())
    for method, path, body in requests:
        replies.append(_http(port, method, path, body, trace_id="cli"))
    t.join(timeout=120)
    assert not t.is_alive()
    port_file.unlink()
    return rc, replies


@pytest.mark.parametrize("streaming", [False, True])
def test_cli_serve_matches_the_jax_cli(tmp_path, streaming):
    """``serve --device cpu ... --quit-after 2`` gives the JAX CLI's
    health and answer bodies, over a resident and a streamed dataset."""
    from mpi_k_selection_tpu.cli import main as jax_main

    from mpi_k_selection_tpu_torch import cli

    argv = ["--n", "20000", "--dtype", "int32", "--batch-window", "0", "--warmup"]
    if streaming:
        argv += ["--streaming", "--chunk-elems", "4096"]
    requests = [("GET", "/healthz", None),
                ("POST", "/v1/query", {"dataset": "default", "op": "quantiles", "qs": [0.01, 0.5], "tier": "exact"})]
    mine = _run_cli_serve(cli.main, argv + ["--device", "cpu"], tmp_path, requests)
    theirs = _run_cli_serve(jax_main, argv, tmp_path, requests)
    assert mine == theirs and mine[0] == [0]


def test_cli_serve_parser_matches_jax():
    from mpi_k_selection_tpu.cli import build_serve_parser as jax_parser

    from mpi_k_selection_tpu_torch.cli import build_serve_parser

    mine = vars(build_serve_parser().parse_args([]))
    assert mine.pop("device") == "cuda"
    assert mine == vars(jax_parser().parse_args([]))
    assert mine["port"] == 8080 and mine["batch_window"] == 0.002
    with pytest.raises(SystemExit):
        build_serve_parser().parse_args(["--gen", "nonsense"])


# ---------------------------------------------------------------------------
# the serve modules compile nothing outside the registry


def test_serve_modules_wrap_nothing_for_compilation():
    """No ``jit``, ``torch.jit`` or ``torch.compile`` call or decorator in
    ``serve/`` outside ``registry.py`` (the lint gate's KSL010 names only
    the JAX wrappers): every built program comes from the program cache."""
    bad = []
    for path in sorted((REPO / "mpi_k_selection_tpu_torch" / "serve").glob("*.py")):
        if path.name == "registry.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            targets = [node.func] if isinstance(node, ast.Call) else getattr(node, "decorator_list", [])
            for t in targets:
                name = ast.unparse(t)
                if name in ("jit", "compile") or name.startswith(("torch.jit", "torch.compile", "jax.jit")):
                    bad.append(f"{path.name}:{node.lineno}: {name}")
    assert bad == []


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_server_on_card(cuda_device):
    """On the card: exact answers of a 2^20 int32 and a float64 dataset
    equal NumPy's, the walk, cached sort, top-k and sketch launch their
    kernels (no plain version called), and dropping the datasets returns
    the allocated bytes."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S

    rng = np.random.default_rng(5)
    xi = rng.integers(-(2**31), 2**31 - 1, size=1 << 20, dtype=np.int32)
    xd = rng.standard_normal(1 << 18)
    mem0 = torch.cuda.memory_allocated()
    for m in (H, S):
        m.reset_counts()
    with KSelectServer(window=0.002) as srv:
        srv.add_dataset("i", xi, warmup=True)
        srv.add_dataset("d", xd)
        assert srv.registry.get("i").device == f"cuda:{torch.cuda.current_device()}"
        assert S.LAUNCHES["sweep_ingest32"] == 1 and S.LAUNCHES["sweep_ingest64"] == 1  # one view each
        for name, x in (("i", xi), ("d", xd)):
            ks = [1, 250, x.size // 2, x.size]
            got = [a.value for a in srv.kselect_many(name, ks, tier="exact")]
            assert np.asarray(got).tobytes() == np.sort(x)[np.asarray(ks) - 1].tobytes()
            a = srv.kselect(name, x.size // 3, tier="sketch")
            assert a.value_bounds[0] <= np.sort(x)[x.size // 3 - 1] <= a.value_bounds[1]
        v, i = srv.topk("i", 128)
        assert np.array_equal(i, np.argsort(-xi.astype(np.int64), kind="stable")[:128])
        assert H.LAUNCHES["radix_histogram32"] and H.LAUNCHES["radix_histogram64"]
        assert H.LAUNCHES["tau_counts32"] and not any(H.PLAIN_CALLS.values()) and not any(S.PLAIN_CALLS.values())
        srv.drop_dataset("i")
        srv.drop_dataset("d")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == mem0
