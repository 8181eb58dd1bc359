"""The port's dispatch lanes and the serving layer's resilience (deadlines,
admission control, the supervisor, the drain, their HTTP mapping) against
the JAX package's (tests/test_serve_lanes.py, tests/test_faults.py's serve
cases).

Lanes: the port keys a device dataset's lane by the device named at
registration, so two datasets on ``cpu:0`` and ``cpu:1`` get two lanes
here, as two arrays on two of the JAX package's virtual CPU devices do
there. Lane names differ (``cpu:0`` against the JAX package's device
strings); the tests compare the lanes' structure and counts, not their
names. Resilience: each scenario runs in both packages and compares the
typed errors, the ``serve.*`` counters and the FaultEvent streams entry for
entry. Flight bundles are rooted in each test's ``tmp_path``. No clock is
read: deadlines are ``Deadline(0.0)`` (long past), ``Deadline.after(s)``
or seconds passed to the server.
"""

from __future__ import annotations

import json
import threading
import types
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from mpi_k_selection_tpu_torch import faults
from mpi_k_selection_tpu_torch import obs as obs_lib
from mpi_k_selection_tpu_torch import serve
from mpi_k_selection_tpu_torch.utils import timing

torch.set_num_threads(1)

N_BIG = 40_000
X = np.random.default_rng(1).integers(-(2**31), 2**31 - 1, size=N_BIG, dtype=np.int32)
Y = np.roll(X, 7)


def _pkg(name):
    """A package's serving surface: ``server``, ``serve`` (the module),
    ``faults``, ``obs``, ``Deadline`` and the registration keywords that
    place a dataset on its first or second device."""
    if name == "torch":
        return types.SimpleNamespace(serve=serve, faults=faults, obs=obs_lib, Deadline=timing.Deadline,
                                     place=({"device": "cpu:0"}, {"device": "cpu:1"}), name=name)
    import jax

    from mpi_k_selection_tpu import faults as jf
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu import serve as js
    from mpi_k_selection_tpu.utils.timing import Deadline as JaxDeadline

    devs = jax.devices()
    assert len(devs) >= 2  # the conftest's 8 virtual CPU devices
    return types.SimpleNamespace(serve=js, faults=jf, obs=jobs, Deadline=JaxDeadline, devs=devs, name=name)


def _add(p, srv, name, data, slot=0, **kw):
    """Register ``data`` on the package's device ``slot``."""
    if p.name == "torch":
        return srv.add_dataset(name, data, **p.place[slot], **kw)
    import jax

    return srv.add_dataset(name, jax.device_put(data, p.devs[slot]), **kw)


def _lane_threads():
    return sorted(t.name for t in threading.enumerate() if t.name.startswith("ksel-serve-lane-") and t.is_alive())


def _faults(o):
    return [e.as_dict() for e in o.events.events if e.kind == "fault"]


def _counters(o, names):
    return {n: o.metrics.counter(n).value for n in names}


# ---------------------------------------------------------------------------
# lanes


@pytest.mark.parametrize("lanes", ["auto", 1, 2])
def test_lanes_structure_matches_jax(lanes):
    """Two datasets on two devices: ``auto`` opens a lane each (distinct
    keys, live ``ksel-serve-lane-*`` threads, gone after close) and ``1``
    one ``lane0``, with the JAX package's lane count and per-lane
    submissions; ``2`` folds the keys by CRC32 onto ``lane0``/``lane1``
    (which lanes depends on the names). Every answer is the JAX package's."""
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        with p.serve.KSelectServer(lanes=lanes) as srv:
            da = _add(p, srv, "a", X, 0)
            db = _add(p, srv, "b", Y, 1)
            keys = (p.serve.lane_key_for(da), p.serve.lane_key_for(db))
            got = [srv.kselect(d, k, tier="exact").value for d in ("a", "b") for k in (3, 1234, N_BIG)]
            summary = srv.batcher.lane_summary()
            structure = (sorted(tuple(v.items()) for v in summary.values()), len(_lane_threads()))
            out.append((np.asarray(got).tobytes(), structure if lanes != 2 else None))
            assert keys[0] != keys[1]
            if name == "torch":
                assert keys == ("cpu:0", "cpu:1")
            if lanes == 1:
                assert set(summary) == {"lane0"}
            elif lanes == 2:
                assert set(summary) == {f"lane{zlib.crc32(k.encode()) % 2}" for k in keys}
            else:
                assert set(summary) == set(keys) and structure[1] == 2
        assert _lane_threads() == []
    assert out[0] == out[1]


def test_port_lane_keys_are_the_recorded_devices():
    """The port keys a device dataset by the device named at registration
    (a ``cpu:1`` tensor reports ``cpu``), a stream by its residency."""
    with serve.KSelectServer() as srv:
        a = srv.add_dataset("a", X, device="cpu:0")
        b = srv.add_dataset("b", Y, device="cpu:1")
        c = srv.add_dataset("c", X, device="cpu")
        s = srv.add_dataset("s", source=np.array_split(X, 4), device="cpu:1")
        assert [serve.lane_key_for(d) for d in (a, b, c, s)] == ["cpu:0", "cpu:1", "cpu", "stream"]
        assert b.data.device == torch.device("cpu")
    with pytest.raises(ValueError):
        serve.KSelectServer(lanes=0)
    with pytest.raises(ValueError):
        serve.LaneDispatcher(lambda items: None, lanes="three")


def test_lanes_answer_concurrently():
    """A lane blocked inside an op does not stall the other device's lane."""
    with serve.KSelectServer() as srv:
        dsa = srv.add_dataset("a", X, device="cpu:0")
        srv.add_dataset("b", Y, device="cpu:1")
        release, entered = threading.Event(), threading.Event()

        def block():
            entered.set()
            release.wait(30)
            return "blocked-op"

        blocker = srv.batcher.submit(serve.PendingQuery("a", "op", ds=dsa, run=block))
        assert entered.wait(10)
        try:
            vb = srv.kselect("b", 99, tier="exact", deadline=20.0).value
            assert vb == np.sort(Y)[98]
        finally:
            release.set()
        assert blocker.wait() == "blocked-op"


class _PoisonDeadline:
    def remaining(self):
        return 30.0

    @property
    def expired(self):
        raise RuntimeError("poisoned deadline (lane-crash probe)")


def test_lane_failure_isolation_matches_jax():
    """One lane's loop crash restarts only that lane: the other never
    notices, both keep answering, and the restart counts, the metric and the
    ``restart`` FaultEvent equal the JAX package's."""
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        o = p.obs.Observability.collecting()
        with p.serve.KSelectServer(obs=o) as srv:
            dsa = _add(p, srv, "a", X, 0)
            _add(p, srv, "b", Y, 1)
            srv.kselect("a", 1, tier="exact")
            srv.kselect("b", 1, tier="exact")
            poisoned = srv.batcher.submit(p.serve.PendingQuery("a", "rank", ks=(1,), ds=dsa,
                                                               deadline=_PoisonDeadline()))
            with pytest.raises(p.serve.DispatchCrashedError):
                poisoned.wait()
            summary = srv.batcher.lane_summary()
            crashed = summary[p.serve.lane_key_for(dsa)]["restarts"]
            after = [srv.kselect(d, 77, tier="exact").value for d in ("a", "b")]
            out.append((crashed, sorted(v["restarts"] for v in summary.values()), srv.batcher.restarts,
                        o.metrics.counter("serve.dispatch_restarts").value, np.asarray(after).tobytes(),
                        _faults(o)))
    assert out[0] == out[1]
    assert out[0][:4] == (1, [0, 1], 1, 1)


def test_per_lane_queue_depth_metric():
    o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
    with serve.KSelectServer(obs=o) as srv:
        srv.add_dataset("a", X, device="cpu:0")
        srv.kselect("a", 12, tier="exact")
        text = srv.render_prometheus()
    assert 'ksel_serve_queue_depth_count{lane="cpu:0"} 1' in text
    assert "ksel_serve_lanes 1" in text


# ---------------------------------------------------------------------------
# deadlines, admission control, supervision, drain


class _Blocker:
    """Parks a lane's dispatch thread until released."""

    def __init__(self, p, srv, dataset="d"):
        self.entered, self.release = threading.Event(), threading.Event()
        self.pending = srv.batcher.submit(p.serve.PendingQuery(dataset, "op", ds=srv.registry.get(dataset),
                                                               run=self._run))
        assert self.entered.wait(5.0)

    def _run(self):
        self.entered.set()
        self.release.wait(10.0)

    def done(self):
        self.release.set()
        self.pending.wait()


def _served(p, **kw):
    o = p.obs.Observability.collecting()
    srv = p.serve.KSelectServer(max_queue_depth=2, retry_after=0.25, obs=o, **kw)
    srv.add_dataset("d", np.arange(1000, dtype=np.int32), **({"device": "cpu"} if p.name == "torch" else {}))
    return srv, o


COUNTERS = ("serve.deadline_exceeded", "serve.load_shed", "serve.dispatch_restarts")


def _scenario_waiter_timeout(p, srv, o):
    b = _Blocker(p, srv)
    try:
        with pytest.raises(p.serve.DeadlineExceededError):
            srv.kselect("d", 5, tier="exact", deadline=0.05)
    finally:
        b.done()


def _scenario_default_deadline(p, srv, o):
    b = _Blocker(p, srv)
    try:
        with pytest.raises(p.serve.DeadlineExceededError):
            srv.kselect("d", 5, tier="exact")
    finally:
        b.done()
    assert int(srv.kselect("d", 5, tier="exact", deadline=30.0).value) == 4  # a generous one overrides it


def _scenario_dispatch_drop(p, srv, o):
    b = _Blocker(p, srv)
    ran = []
    expired = srv.batcher.submit(p.serve.PendingQuery("d", "op", ds=srv.registry.get("d"),
                                                      run=lambda: ran.append(1), deadline=p.Deadline(0.0)))
    b.done()
    with pytest.raises(p.serve.DeadlineExceededError, match="dropped unrun"):
        expired.wait()
    assert ran == []


def _scenario_shed(p, srv, o):
    b = _Blocker(p, srv)
    admitted = []
    try:
        with pytest.raises(p.serve.ServerOverloadedError) as ei:
            for _ in range(10):
                admitted.append(srv.batcher.submit(p.serve.PendingQuery("d", "op", ds=srv.registry.get("d"),
                                                                        run=lambda: 1)))
        assert ei.value.retry_after == 0.25 and len(admitted) == 2
    finally:
        b.done()
        for item in admitted:
            item.wait()
    srv.collect_metrics()


SCENARIOS = {
    "waiter_timeout": (_scenario_waiter_timeout, {}),
    "default_deadline": (_scenario_default_deadline, {"default_deadline": 0.05}),
    "dispatch_drop": (_scenario_dispatch_drop, {}),
    "shed": (_scenario_shed, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_resilience_matches_jax(scenario):
    """Each scenario in both packages: the typed error, the ``serve.*``
    counters and the FaultEvent stream entry for entry."""
    run, kw = SCENARIOS[scenario]
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        srv, o = _served(p, **kw)
        try:
            run(p, srv, o)
        finally:
            srv.close()
        out.append((_counters(o, COUNTERS), _faults(o)))
    assert out[0] == out[1]
    want = {"waiter_timeout": "deadline", "default_deadline": "deadline", "dispatch_drop": "deadline",
            "shed": "shed"}[scenario]
    assert [e["action"] for e in out[0][1]] == [want]


def test_supervisor_restart_under_a_fault_plan_matches_jax(tmp_path):
    """``FaultPlan((FaultSpec("serve.dispatch", 0, "raise"),))`` crashes the
    first dispatch round: that query gets DispatchCrashedError, the loop
    restarts in place (later queries answer), one flight bundle is written,
    and the counters, ``injector.fired`` and FaultEvents equal the JAX
    package's."""
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        root = tmp_path / name
        root.mkdir()
        rec = p.obs.FlightRecorder(dump_dir=str(root))
        srv, o = _served(p, flight=rec)
        try:
            plan = p.faults.FaultPlan((p.faults.FaultSpec("serve.dispatch", 0, "raise"),))
            with p.faults.inject(plan) as inj:
                with pytest.raises(p.serve.DispatchCrashedError, match="TransientError"):
                    srv.kselect("d", 5, tier="exact")
            assert int(srv.kselect("d", 5, tier="exact").value) == 4
            srv.collect_metrics()
            bundles = sorted(root.iterdir())
            assert len(bundles) == 1 and rec.auto_dumps == [str(bundles[0])]
            bundle = json.loads(bundles[0].read_text())
            out.append((srv.batcher.restarts, _counters(o, COUNTERS), inj.fired, _faults(o), bundle["reason"],
                        sorted(bundle)))
            bundles[0].unlink()
        finally:
            srv.close()
        p.obs.flight.drain_dumped()
    assert out[0] == out[1]
    assert out[0][0] == 1 and out[0][4] == "dispatch-crashed"
    assert [e["action"] for e in out[0][3]] == ["restart"]


def test_graceful_drain_on_close():
    srv = serve.KSelectServer()
    srv.add_dataset("d", np.arange(128, dtype=np.int32), device="cpu")
    ds = srv.registry.get("d")
    results = []
    pendings = [srv.batcher.submit(serve.PendingQuery("d", "op", ds=ds, run=lambda i=i: results.append(i)))
                for i in range(8)]
    srv.close()  # queued work finishes before the join
    for p in pendings:
        p.wait()
    assert sorted(results) == list(range(8))
    with pytest.raises(serve.ServerClosedError):
        srv.batcher.submit(serve.PendingQuery("d", "op", ds=ds, run=lambda: 1))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, None, json.loads(r.read())["answers"][0]["value"]
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())["error"]


def test_http_deadline_and_shed_mapping_match_jax():
    """Over HTTP: a generous ``deadline_ms`` answers; negative, NaN,
    infinite and boolean ones are 400s; an expired one is a 504; a full
    queue a 503 with ``Retry-After: 1``; as the JAX front maps them."""
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        srv, o = _served(p)
        got = []
        try:
            with p.serve.start_http_server(srv) as h:
                url = f"http://127.0.0.1:{h.port}/v1/query"
                got.append(_post(url, {"dataset": "d", "op": "kselect", "k": 3, "deadline_ms": 60000}))
                for bad in (-5, float("nan"), float("inf"), True):
                    got.append(_post(url, {"dataset": "d", "op": "kselect", "k": 3, "deadline_ms": bad})[:2])
                b = _Blocker(p, srv)
                try:
                    got.append(_post(url, {"dataset": "d", "op": "kselect", "k": 3, "tier": "exact",
                                           "deadline_ms": 30})[:2])
                    for _ in range(2):
                        try:
                            srv.batcher.submit(p.serve.PendingQuery("d", "op", ds=srv.registry.get("d"),
                                                                    run=lambda: 1))
                        except p.serve.ServerOverloadedError:
                            break
                    got.append(_post(url, {"dataset": "d", "op": "kselect", "k": 3, "tier": "exact"}))
                finally:
                    b.done()
        finally:
            srv.close()
        out.append((got, [e["action"] for e in _faults(o)]))
    assert out[0] == out[1]
    assert [g[0] for g in out[0][0]] == [200, 400, 400, 400, 400, 504, 503]
    assert out[0][0][0][2] == 2 and out[0][0][-1][1] == "1"
