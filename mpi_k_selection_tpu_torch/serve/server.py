"""KSelectServer: the in-process resident-dataset query server
(counterpart of ``mpi_k_selection_tpu/serve/server.py``).

It composes a :class:`~mpi_k_selection_tpu_torch.serve.registry.
DatasetRegistry` (resident datasets and the keyed program cache), a
:class:`~mpi_k_selection_tpu_torch.serve.lanes.LaneDispatcher` (one
supervised dispatch lane a device, each a bounded-window
:class:`~mpi_k_selection_tpu_torch.serve.batcher.QueryBatcher`) and the
latency tiers (serve/tiers.py). The HTTP front (serve/http.py) and the
CLI's ``serve`` are thin shells over it::

    from mpi_k_selection_tpu_torch.serve import KSelectServer

    with KSelectServer(window=0.002) as srv:
        srv.add_dataset("logits", x, warmup=True)  # on cuda, built once
        a = srv.kselect("logits", k, tier="auto")
        qs = srv.quantiles("logits", [0.5, 0.99], tier="sketch")
        qs[0].rank_error_bound                    # bounds always attached

Guarantees:

- **Determinism**: answers are the bits of serial ``api.kselect`` /
  ``api.quantiles`` calls, for every tier, residency, window, client
  count, lane layout, ``fast_path`` and ``warmup``: each dataset's device
  work runs on one lane thread, resident data is immutable, and exact
  order statistics do not depend on the batch that computed them.
- **Hot path**: sketch-tier answers (and auto answers the sketch pins) are
  NumPy reads of an immutable pyramid, answered on the request thread
  with ``fast_path=True`` (default; ``serve.fastpath{tier=}``).
  ``fast_path=False`` routes them through the lane: the oracle of the
  fast path. Exact work always goes through the dataset's lane.
- **No rebuilds on repeat shapes**: walk closures and cached sorts live in
  the registry's program cache (``serve.program_cache.{hits,misses}``
  mirror its counters).
- **Observability**: with an :class:`~mpi_k_selection_tpu_torch.obs.
  Observability`, one ``serve.query`` event a request, one
  ``serve.batch`` event a coalesced group, and the ``serve.*`` metrics
  (queue depth, batch width, queries by tier and op, latency histograms
  by tier, escalations). Off by default; never changes an answer bit.
- **No fallback**: a dataset registered on the default device lives on
  ``cuda``; without a card the registration raises, and no query is ever
  answered on the CPU in its place.
- **Clean shutdown**: ``close()`` joins every lane thread and fails queued
  stragglers with :class:`ServerClosedError`; no ``ksel-serve-*`` thread
  outlives the server.
"""

from __future__ import annotations

import uuid

import numpy as np

from mpi_k_selection_tpu_torch.serve import tiers as _tiers
from mpi_k_selection_tpu_torch.serve.batcher import (
    DEFAULT_MAX_BATCH,
    PendingQuery,
)
from mpi_k_selection_tpu_torch.serve.lanes import LaneDispatcher
from mpi_k_selection_tpu_torch.serve.errors import (
    DeadlineExceededError,
    QueryError,
    ServerClosedError,
)
from mpi_k_selection_tpu_torch.serve.registry import DatasetRegistry
from mpi_k_selection_tpu_torch.serve.tiers import RankAnswer
from mpi_k_selection_tpu_torch.utils.timing import Deadline

#: Latency-histogram bucket bounds (seconds) — sub-ms sketch reads up to
#: multi-second out-of-core descents.
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)

OPS = ("kselect", "quantiles", "topk", "rank_certificate")


class _LatencyRecorder:
    """PhaseTimer recorder bridging request phases to the obs channels:
    observes each finished ``serve.request.<tier>`` duration into the
    per-tier latency histogram and forwards every span — with its
    ``args`` context (the request/walk trace ids) — to the trace
    recorder and the flight ring. Receives finished ``(name, t0, t1)``
    triples only: no clock is read here."""

    def __init__(self, metrics, trace, flight=None):
        self._metrics = metrics
        self._trace = trace
        self._flight = flight

    def record(self, name: str, t0: float, t1: float, args=None) -> None:
        if self._metrics is not None and name.startswith("serve.request."):
            tier = name.rsplit(".", 1)[-1]
            self._metrics.histogram(
                "serve.latency_seconds",
                labels={"tier": tier},
                buckets=LATENCY_BUCKETS,
            ).observe(t1 - t0)
        if self._trace is not None:
            self._trace.record(name, t0, t1, args)
        if self._flight is not None:
            self._flight.record(name, t0, t1, args)


class KSelectServer:
    """Long-lived serving facade: register datasets once, answer
    kselect / quantile / top-k / rank-certificate queries from many
    concurrent clients. ``window`` is the batcher's coalescing window in
    seconds (0 = dispatch every request alone).

    Hot-path knobs: ``fast_path`` (default True) answers sketch-tier
    (and auto-pinned) queries inline on the request thread —
    ``fast_path=False`` is the queued bit-for-bit oracle; ``lanes``
    (``"auto"`` = one dispatch lane per distinct execution device, or
    an explicit int: ``1`` is the single batcher)
    routes each dataset's exact-tier work to its device's lane.

    Resilience knobs: ``max_queue_depth`` bounds
    each lane's dispatch queue — arrivals past it are shed with
    :class:`~mpi_k_selection_tpu_torch.serve.errors.ServerOverloadedError`
    (HTTP 503 + ``Retry-After``, ``retry_after`` seconds, counted in
    ``serve.load_shed``) instead of queueing unboundedly;
    ``default_deadline`` (seconds) applies to every query that names
    none — expired queries fail fast with
    :class:`~mpi_k_selection_tpu_torch.serve.errors.DeadlineExceededError`
    (HTTP 504, ``serve.deadline_exceeded``); the dispatch loop runs
    supervised — a crash fails only the in-flight batch and restarts the
    loop (``serve.dispatch_restarts``)."""

    def __init__(
        self,
        *,
        window: float = 0.0,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_queue_depth: int | None = None,
        retry_after: float = 1.0,
        default_deadline: float | None = None,
        fast_path: bool = True,
        lanes="auto",
        latency_windows=None,
        flight=None,
        obs=None,
        registry: DatasetRegistry | None = None,
    ):
        from mpi_k_selection_tpu_torch.obs import Observability
        from mpi_k_selection_tpu_torch.obs.flight import resolve_flight

        from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

        # flight (off by default): the postmortem ring (obs/flight.py) —
        # True/int/FlightRecorder per resolve_flight. It attaches to the
        # obs bundle so every emitted event fans into it; a server built
        # without obs gets a flight-only bundle, so debug_bundle() and
        # the auto-dump triggers work regardless.
        fr = resolve_flight(flight)
        if fr is not None:
            if obs is None:
                obs = Observability(flight=fr)
            elif obs.flight is None:
                obs.flight = fr
            elif flight is not True and obs.flight is not fr:
                # a concrete recorder (or capacity) that conflicts with
                # the obs bundle's existing ring must not be silently
                # dropped — auto-dumps would freeze the wrong ring;
                # flight=True just means "on" and keeps the existing one
                raise ValueError(
                    "flight= names a recorder but obs already carries a "
                    "different flight ring — pass one of them, or "
                    "flight=True to keep the obs ring"
                )
        self.obs = obs
        self.flight = None if obs is None else obs.flight
        self.metrics = None if obs is None else obs.metrics
        # latency_windows (off by default): back serve.latency_seconds
        # with a sliding-window RadixSketch (obs/windows.py), so /metrics
        # p50/p90/p99 become windowed, EXACTLY-bounded quantiles instead
        # of fixed-bucket interpolation. True = defaults (8 buckets x 256
        # observations); an int = that many window buckets; a dict
        # forwards to MetricsRegistry.enable_windowed (window/
        # advance_every/decay/quantiles). Purely observational — answers
        # are bit-identical with the knob on.
        if latency_windows:
            if self.metrics is None:
                raise ValueError(
                    "latency_windows needs a metrics registry: pass "
                    "obs=Observability(metrics=MetricsRegistry()) — the "
                    "windowed quantiles live in /metrics"
                )
            if latency_windows is True:
                spec = {}
            elif isinstance(latency_windows, int):
                spec = {"window": latency_windows}
            else:
                spec = dict(latency_windows)
            self.metrics.enable_windowed("serve.latency_seconds", **spec)
        self._owns_registry = registry is None
        self._closed = False
        self.registry = registry if registry is not None else DatasetRegistry()
        # the program cache reports into the process ProgramLedger; give
        # its storm events this server's sink — but never STEAL the sink
        # of a shared caller-owned registry another server already wired
        # (its storms would land on the wrong event stream)
        if self._owns_registry or self.registry.programs.obs is None:
            self.registry.programs.obs = self.obs
        self.default_deadline = (
            None if default_deadline is None else float(default_deadline)
        )
        self.timer = PhaseTimer(
            recorder=_LatencyRecorder(
                self.metrics,
                None if obs is None else obs.trace,
                self.flight,
            )
        )
        self.fast_path = bool(fast_path)
        self.batcher = LaneDispatcher(
            self._execute_ranks,
            lanes=lanes,
            window=window,
            max_batch=max_batch,
            max_depth=max_queue_depth,
            retry_after=retry_after,
            observe_depth=self._observe_depth,
            observe_width=self._observe_width,
            observe_shed=self._observe_shed,
            observe_expired=self._observe_expired,
            observe_restart=self._observe_restart,
        )

    # -- dataset lifecycle -------------------------------------------------

    def _get(self, dataset_id: str):
        """Resolve a dataset for a request, with the closed check FIRST:
        close() empties an owned registry, so without it a post-close
        query would read as "dataset not found" instead of the
        documented :class:`ServerClosedError`."""
        if self._closed:
            raise ServerClosedError("server is closed; query rejected")
        return self.registry.get(dataset_id)

    def add_dataset(
        self, dataset_id: str, data=None, *, source=None,
        warmup: bool = False, **kwargs
    ):
        """Register a dataset: ``data`` (an array, placed on ``device=``
        once, ``"cuda"`` by default) or ``source`` (a replayable chunk
        source, sketched once; exact queries re-stream it). ``warmup=True``
        also builds the dataset's selection programs (the cached sort, the
        walk closure with one width-1 query run, the stream-select
        closure, the sketch's pin path) through the program cache now: the
        kernel builds and first launches land here, clocked under the
        ledger's ``serve.programs`` compile book, instead of on the first
        client (``serve.warmup_compiles`` counts the programs built).
        Other keywords (``device``, ``sketch``, ``sketch_bits``,
        ``sketch_levels``, a stream's descent knobs) as
        :meth:`DatasetRegistry.add_array` / :meth:`add_stream` take
        them."""
        if self._closed:
            # a post-close registration would re-enter the ledger's
            # resident byte book with nothing left to release it
            raise ServerClosedError("server is closed; query rejected")
        if (data is None) == (source is None):
            raise QueryError("pass exactly one of data= or source=")
        if data is not None:
            ds = self.registry.add_array(dataset_id, data, **kwargs)
        else:
            ds = self.registry.add_stream(dataset_id, source, **kwargs)
        if warmup:
            built = self.registry.warmup(ds)
            if self.metrics is not None:
                self.metrics.counter("serve.warmup_compiles").inc(built)
        if self.metrics is not None:
            self.metrics.gauge("serve.datasets").set(len(self.registry))
        return ds

    def drop_dataset(self, dataset_id: str) -> None:
        self.registry.drop(dataset_id)
        if self.metrics is not None:
            self.metrics.gauge("serve.datasets").set(len(self.registry))

    def list_datasets(self) -> list[dict]:
        return self.registry.list_datasets()

    # -- queries (request threads) -----------------------------------------

    def kselect(
        self, dataset_id: str, k, *, tier: str = "auto", deadline=None,
        trace_id=None,
    ) -> RankAnswer:
        """Exact-or-bounded k-th smallest (1-indexed). Returns one
        :class:`RankAnswer`; ``tier`` per serve/tiers.py. ``deadline``
        (seconds, or a :class:`~mpi_k_selection_tpu_torch.utils.timing.
        Deadline`) bounds the whole request — expiry raises the typed
        :class:`~mpi_k_selection_tpu_torch.serve.errors.
        DeadlineExceededError` (HTTP 504). ``trace_id`` is the request-
        correlation id (minted when None); it rides the query's events
        and spans."""
        ds = self._get(dataset_id)
        return self._rank_query(ds, [k], tier, "kselect", deadline, trace_id)[0]

    def kselect_many(
        self, dataset_id: str, ks, *, tier: str = "auto", deadline=None,
        trace_id=None,
    ):
        """One :class:`RankAnswer` per rank in ``ks``, in order — the
        whole request rides one dispatch (and one shared walk)."""
        ds = self._get(dataset_id)
        return self._rank_query(ds, list(ks), tier, "kselect", deadline, trace_id)

    def quantiles(
        self, dataset_id: str, qs, *, tier: str = "auto", deadline=None,
        trace_id=None,
    ):
        """Nearest-rank quantile answers (``api.quantile_ranks``
        conversion, so exact-tier values are bit-identical to
        ``api.quantiles`` over the same resident bits)."""
        from mpi_k_selection_tpu_torch.api import quantile_ranks

        ds = self._get(dataset_id)
        try:
            ks = quantile_ranks(qs, ds.n)
        except ValueError as e:
            raise QueryError(str(e)) from e
        return self._rank_query(ds, ks, tier, "quantiles", deadline, trace_id)

    def topk(
        self, dataset_id: str, k: int, *, largest: bool = True, deadline=None,
        trace_id=None,
    ):
        """Exact top-k ``(values, indices)`` over a resident dataset
        (earliest-position tie break, as ``lax.top_k``), NumPy arrays."""
        ds = self._get(dataset_id)
        tid = self._trace_id(trace_id)
        result = self._run_single(
            ds, "topk",
            lambda: self.registry.topk(ds, k, largest=largest),
            deadline, tid,
        )
        self._account(ds, "topk", None, "exact", 1, False, tid)
        return result

    def rank_certificate(
        self, dataset_id: str, value, *, deadline=None, trace_id=None
    ):
        """Exact ``(#<, #<=)`` counts for ``value`` — the O(n) proof a
        served answer is the true order statistic."""
        ds = self._get(dataset_id)
        tid = self._trace_id(trace_id)
        result = self._run_single(
            ds, "rank_certificate",
            lambda: self.registry.rank_certificate(ds, value),
            deadline, tid,
        )
        self._account(ds, "rank_certificate", None, "exact", 1, False, tid)
        return result

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _trace_id(trace_id) -> str:
        """Honor a caller-supplied correlation id, mint one otherwise
        (the HTTP front passes the client's ``X-Ksel-Trace-Id`` through
        here, so one id follows a query across services). The id is
        echoed verbatim into response HEADERS, so it is clamped to
        printable ASCII and bounded — an obs-folded inbound value
        (``abc\\r\\n\\tevil`` survives the stdlib header parse) must not
        become a CR/LF header-injection primitive on the echo. An id
        that sanitizes to nothing is replaced by a minted one."""
        if trace_id:
            tid = "".join(c for c in str(trace_id)[:128] if " " <= c <= "~")
            if tid:
                return tid
        return uuid.uuid4().hex[:16]

    def _check_open(self) -> None:
        if self.batcher.closed:
            raise ServerClosedError("server is closed")

    def _resolve_deadline(self, deadline):
        if deadline is None:
            deadline = self.default_deadline
        if deadline is None or isinstance(deadline, Deadline):
            return deadline
        return Deadline.after(float(deadline))

    def _wait(self, pending):
        """Wait for a dispatched query, accounting deadline expiry: the
        waiter-side timeout is counted here; dispatch-side drops were
        already counted by the expired hook (``pending.error`` carries
        the same exception instance then — count once)."""
        try:
            return pending.wait()
        except DeadlineExceededError as e:
            if pending.error is not e:
                self._fault_obs("serve.request", "deadline", e)
                if self.metrics is not None:
                    self.metrics.counter("serve.deadline_exceeded").inc()
            raise

    def _rank_query(
        self, ds, ks, tier, op, deadline=None, trace_id=None
    ) -> list[RankAnswer]:
        """``ds`` is the RESOLVED dataset (not an id): validation and
        execution must describe the same object even if the id is
        dropped and re-registered mid-request."""
        self._check_open()
        tier = _tiers.validate_tier(tier)
        dl = self._resolve_deadline(deadline)
        tid = self._trace_id(trace_id)
        ks = [int(k) for k in ks]
        for k in ks:
            if not 1 <= k <= ds.n:
                raise QueryError(f"k={k} out of range [1, {ds.n}]")
        if tier == "sketch" or (tier == "auto" and _tiers.auto_pins(ds, ks)):
            _tiers.require_sketch(ds)
            with self.timer.phase(
                "serve.request.sketch", args={"trace_id": tid}
            ):
                if self.fast_path:
                    # the sketch is immutable and its reads are pure
                    # numpy: answer on the request thread — no enqueue,
                    # no dispatch wake, no lane serialization needed
                    answers = _tiers.sketch_answers(ds, ks)
                    if self.metrics is not None:
                        self.metrics.counter(
                            "serve.fastpath", labels={"tier": tier}
                        ).inc()
                else:
                    # the queued oracle: same answers, through the lane
                    pending = self.batcher.submit(
                        PendingQuery(
                            ds.dataset_id, "sketch", ds=ds, deadline=dl,
                            trace_id=tid,
                            run=lambda: _tiers.sketch_answers(ds, ks),
                        )
                    )
                    answers = self._wait(pending)
            self._account(ds, op, tier, "sketch", len(ks), False, tid)
            return answers
        escalated = tier == "auto"
        with self.timer.phase("serve.request.exact", args={"trace_id": tid}):
            pending = self.batcher.submit(
                PendingQuery(
                    ds.dataset_id, "rank", ks=tuple(ks), ds=ds, deadline=dl,
                    trace_id=tid,
                )
            )
            values = self._wait(pending)
        answers = [
            RankAnswer(
                k=k, value=values[i], tier="exact", exact=True,
                escalated=escalated,
            )
            for i, k in enumerate(ks)
        ]
        self._account(ds, op, tier, "exact", len(ks), escalated, tid)
        return answers

    def _run_single(self, ds, kind, run, deadline=None, trace_id=None):
        """Route one non-rank op through the dispatch thread (all device
        work stays serialized there)."""
        self._check_open()
        dl = self._resolve_deadline(deadline)
        with self.timer.phase(
            "serve.request.exact", args={"trace_id": trace_id}
        ):
            return self._wait(
                self.batcher.submit(
                    PendingQuery(
                        ds.dataset_id, kind, ds=ds, run=run, deadline=dl,
                        trace_id=trace_id,
                    )
                )
            )

    def _execute_ranks(self, items) -> None:
        """Dispatch-thread executor: ONE shared-pass select over the
        coalesced ranks of every request in the group (all items carry
        the same resolved dataset object), split back in submission
        order. The walk span carries every rider's trace id, so one
        slow coalesced walk is joinable back to the client requests
        that rode it (and to their FaultEvents)."""
        ds = items[0].ds
        all_ks = [k for item in items for k in item.ks]
        trace_ids = tuple(i.trace_id for i in items if i.trace_id)
        with self.timer.phase(
            "serve.walk",
            args={"dataset": ds.dataset_id, "trace_ids": list(trace_ids)},
        ):
            values = np.asarray(self.registry.select_many(ds, all_ks))
        pos = 0
        for item in items:
            item.result = values[pos : pos + len(item.ks)]
            pos += len(item.ks)
        if self.obs is not None:
            from mpi_k_selection_tpu_torch.obs.events import ServeBatchEvent

            self.obs.emit(
                ServeBatchEvent(
                    dataset=ds.dataset_id,
                    requests=len(items),
                    width=len(all_ks),
                    trace_ids=trace_ids,
                )
            )

    def _observe_depth(self, depth: int, lane: str) -> None:
        if self.metrics is not None:
            self.metrics.histogram(
                "serve.queue_depth", labels={"lane": lane}
            ).observe(depth)

    def _observe_width(self, width: int) -> None:
        if self.metrics is not None:
            self.metrics.histogram("serve.batch_width").observe(width)

    def _fault_obs(self, site: str, action: str, exc=None) -> None:
        """One serving-layer fault observation (shed, deadline, restart)
        — a typed FaultEvent; the matching counters are kept next to the
        call sites (some mirror pre-existing sources rather than inc)."""
        from mpi_k_selection_tpu_torch.obs.wiring import fault_event

        fault_event(self.obs, site, action, exc=exc)

    def _observe_shed(self) -> None:
        self._fault_obs("serve.submit", "shed")
        if self.metrics is not None:
            self.metrics.counter("serve.load_shed").inc()

    def _observe_expired(self) -> None:
        self._fault_obs("serve.dispatch", "deadline")
        if self.metrics is not None:
            self.metrics.counter("serve.deadline_exceeded").inc()

    def _observe_restart(self, exc, lane: str) -> None:
        self._fault_obs("serve.dispatch", "restart", exc)
        if self.metrics is not None:
            # mirror of the lanes' own counters (set, not inc: the lane
            # increments BEFORE this hook runs, and collect_metrics
            # re-mirrors the sum idempotently)
            self.metrics.counter("serve.dispatch_restarts").set(
                int(self.batcher.restarts)
            )
        # a supervisor restart means a DispatchCrashedError reached
        # clients: freeze the postmortem ring ONCE (obs/flight.py; no-op
        # without a flight channel, never raises)
        from mpi_k_selection_tpu_torch.obs.flight import auto_dump

        auto_dump(self.obs, "dispatch-crashed", exc=exc)

    def _account(
        self, ds, op, tier_requested, tier_answered, queries, escalated,
        trace_id=None,
    ):
        """Per-request accounting: one ``serve.query`` event plus the
        tier/op counters. Pure host-int observation."""
        if self.obs is None:
            return
        from mpi_k_selection_tpu_torch.obs.events import ServeQueryEvent

        self.obs.emit(
            ServeQueryEvent(
                dataset=ds.dataset_id,
                op=op,
                tier_requested=tier_requested,
                tier_answered=tier_answered,
                queries=queries,
                escalated=escalated,
                trace_id=trace_id,
            )
        )
        if self.metrics is not None:
            self.metrics.counter(
                "serve.queries", labels={"tier": tier_answered, "op": op}
            ).inc()
            if escalated:
                self.metrics.counter("serve.tier_escalations").inc()

    def collect_metrics(self):
        """Fold the registry/program-cache/phase state into the metrics
        registry (idempotent snapshot — the same overwrite discipline as
        ``obs.metrics.collect_runtime``) and return it. The /metrics
        endpoint and ``render_prometheus`` call this before exposition."""
        if self.metrics is None:
            return None
        from mpi_k_selection_tpu_torch.obs.ledger import collect_ledger
        from mpi_k_selection_tpu_torch.obs.metrics import collect_runtime

        self.metrics.counter("serve.program_cache.hits").set(
            int(self.registry.programs.hits)
        )
        self.metrics.counter("serve.program_cache.misses").set(
            int(self.registry.programs.misses)
        )
        self.metrics.gauge("serve.program_cache.entries").set(
            len(self.registry.programs)
        )
        self.metrics.gauge("serve.datasets").set(len(self.registry))
        self.metrics.counter("serve.dispatch_restarts").set(
            int(self.batcher.restarts)
        )
        self.metrics.gauge("serve.lanes").set(self.batcher.lane_count)
        collect_runtime(self.metrics, timer=self.timer)
        # the process ProgramLedger's compile/byte book rides /metrics
        # too (ledger.compiles{site=}, ledger.device_bytes{pool=,device=})
        collect_ledger(self.metrics)
        return self.metrics

    def _server_section(self) -> dict:
        return {
            "datasets": self.list_datasets(),
            "program_cache": {
                "hits": int(self.registry.programs.hits),
                "misses": int(self.registry.programs.misses),
                "entries": len(self.registry.programs),
            },
            "dispatch_restarts": int(self.batcher.restarts),
            "fast_path": self.fast_path,
            "lanes": self.batcher.lane_summary(),
            "closed": self.batcher.closed,
        }

    def debug_bundle(self, *, reason: str = "on-demand") -> dict:
        """Assemble the JSON-ready debug bundle (obs/flight.py): the
        flight ring's event/span tails (empty without a ``flight=``
        channel — the bundle degrades gracefully), the live metrics
        snapshot, the process ledger, the fault section, and this
        server's own state. ``GET /debug/bundle`` serves exactly this."""
        from mpi_k_selection_tpu_torch.obs.flight import build_bundle

        if self.metrics is not None:
            self.collect_metrics()
        return build_bundle(
            self.obs, reason=reason, extra={"server": self._server_section()}
        )

    def dump_debug_bundle(self, path, *, reason: str = "on-demand") -> str:
        """:meth:`debug_bundle` written as JSON through the flight
        ring's registered dump (the CLI ``--debug-bundle`` shutdown
        artifact) — the ``server`` section rides along, which a bare
        ``FlightRecorder.dump`` would drop. Requires the ``flight=``
        channel."""
        if self.flight is None:
            raise ValueError("dump_debug_bundle needs the flight= channel")
        if self.metrics is not None:
            self.collect_metrics()
        return self.flight.dump(
            path, obs=self.obs, reason=reason,
            extra={"server": self._server_section()},
        )

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the server metrics (empty when
        the server runs without a metrics registry)."""
        metrics = self.collect_metrics()
        return "" if metrics is None else metrics.render_prometheus()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Join every dispatch-lane thread; fail queued stragglers. A
        registry
        this server created is closed too (its datasets leave the ledger
        resident byte book); a caller-provided one stays the caller's.
        Idempotent."""
        self._closed = True
        self.batcher.close()
        if self._owns_registry:
            self.registry.close()

    def __enter__(self) -> "KSelectServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
