"""Flight recorder: a bounded ring of recent telemetry, and the
fault-triggered JSON debug bundle (counterpart of
``mpi_k_selection_tpu/obs/flight.py``).

The recorder keeps the most recent typed events and host spans in two
fixed-size rings (it is a PhaseTimer recorder, so spans arrive through the
same route as the trace recorder's), appended in O(1) under a lock. It is
off by default: attach one as the ``flight`` channel of an
:class:`~mpi_k_selection_tpu_torch.obs.Observability` and every event and
span it sees is kept, the oldest evicted first.

On demand (the CLI's ``--debug-bundle PATH``), or automatically, once per
recorder, on a terminal failure (``RetryExhaustedError`` or unrecoverable
spill damage in the descent's recovery ladder), the rings are dumped as
one JSON bundle with five sections that are always there
(:data:`BUNDLE_SECTIONS`):

- ``events``: the typed-event tail (FaultEvents included), in order;
- ``metrics``: the live registry (ledger gauges folded in);
- ``ledger``: the process ProgramLedger snapshot;
- ``spans``: the span tail with each span's thread, and the count of
  distinct threads;
- ``faults``: the FaultEvent tail, and the armed plan when an injector
  is armed;

plus ``lock_order``, which is None in the port: the JAX package fills it
from its lock-order sanitizer (``analysis/lockorder.py``), and the port's
analysis is ROADMAP Queue 1 item 7; and ``reason``, with an ``error`` where
a failure triggered the dump. An automatic dump's file name starts with
:data:`FLIGHT_FILE_PREFIX`, and every dump is registered
(:func:`drain_dumped`) so a test suite can validate each bundle. The
recorder only observes the host: it never changes an answer bit.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading

#: Prefix of an automatic dump's file (the JAX package's
#: ``resource_protocols.FLIGHT_FILE_PREFIX``, so one leak check covers
#: both packages' bundles).
FLIGHT_FILE_PREFIX = "ksel-flight-"

#: Default ring capacity (events, and spans unless given): a streamed
#: pass emits one event a chunk, so 512 holds several recent passes.
DEFAULT_CAPACITY = 512

#: The five sections every bundle carries.
BUNDLE_SECTIONS = ("events", "metrics", "ledger", "spans", "faults")

# every bundle path written by this process (automatic and on-demand
# dumps alike), drained by a test suite's check
_DUMPED_LOCK = threading.Lock()
_DUMPED: list[str] = []  # ksel: guarded-by[_DUMPED_LOCK]


def _register_dump(path: str) -> None:
    with _DUMPED_LOCK:
        _DUMPED.append(path)


def drain_dumped() -> list[str]:
    """Return and clear the bundle paths written since the last drain."""
    with _DUMPED_LOCK:
        out, _DUMPED[:] = list(_DUMPED), []
    return out


class FlightRecorder:
    """The bounded telemetry ring. Thread-safe: events arrive from the
    producer and consumer threads, spans from whichever thread ran the
    phase. ``dump_dir`` roots the automatic dumps (default: the temp
    dir)."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY, span_capacity: int | None = None,
                 dump_dir: str | None = None):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=max(1, int(capacity)))
        self._spans: collections.deque = collections.deque(
            maxlen=max(1, int(span_capacity if span_capacity is not None else capacity)))
        self._seq = 0  # ksel: guarded-by[_lock] (events seen, evicted included)
        self._auto_dumped = False  # ksel: guarded-by[_lock]
        self.dump_dir = None if dump_dir is None else os.fspath(dump_dir)
        self.auto_dumps: list[str] = []  # ksel: guarded-by[_lock]

    def record_event(self, event) -> None:
        """Keep one typed event (``Observability.emit`` fans in here)."""
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, event))

    def record(self, name: str, t0: float, t1: float, args=None) -> None:
        """The PhaseTimer recorder protocol: keep one finished span with
        its thread (no clock is read here)."""
        t = threading.current_thread()
        with self._lock:
            self._spans.append((name, t0, t1, t.ident or 0, t.name, args))

    def events_tail(self) -> list:
        with self._lock:
            return [e for _, e in self._events]

    def spans_tail(self) -> list:
        """The kept span tuples, oldest first."""
        with self._lock:
            return list(self._spans)

    def bundle(self, *, obs=None, reason: str = "on-demand", extra=None) -> dict:
        """The debug bundle as a dict (the module docstring's sections);
        ``obs`` supplies the live registry, ``extra`` top-level keys."""
        return build_bundle(obs, reason=reason, flight=self, extra=extra)

    def dump(self, path=None, *, obs=None, reason: str = "on-demand", extra=None) -> str:
        """Write one bundle as JSON: to ``path``, or to a new
        ``ksel-flight-*.json`` under ``dump_dir`` (the temp dir by
        default). Every dump is registered (:func:`drain_dumped`)."""
        payload = self.bundle(obs=obs, reason=reason, extra=extra)
        if path is None:
            fd, path = tempfile.mkstemp(prefix=FLIGHT_FILE_PREFIX, suffix=".json", dir=self.dump_dir)
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        else:
            path = os.fspath(path)
            with open(path, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        _register_dump(path)
        return path

    def maybe_auto_dump(self, reason: str, *, obs=None, exc=None) -> str | None:
        """The fault-triggered dump: at most one per recorder (a retry
        storm must not write a bundle per attempt). Returns the path, or
        None when this recorder has dumped already. A failed write does
        not use up the one dump: the trigger is often the very condition
        (ENOSPC) that fails the write."""
        with self._lock:
            if self._auto_dumped:
                return None
            self._auto_dumped = True
        extra = {} if exc is None else {"error": f"{type(exc).__name__}: {exc}"}
        try:
            path = self.dump(None, obs=obs, reason=reason, extra=extra)
        except BaseException:
            with self._lock:
                self._auto_dumped = False
            raise
        with self._lock:
            self.auto_dumps.append(path)
        return path


def resolve_flight(flight) -> FlightRecorder | None:
    """The ``flight=`` knob: None or False = off, True = a default
    recorder, an int = that ring capacity, a FlightRecorder = itself."""
    if flight is None or flight is False:
        return None
    if flight is True:
        return FlightRecorder()
    if isinstance(flight, FlightRecorder):
        return flight
    if isinstance(flight, int):
        return FlightRecorder(capacity=flight)
    raise ValueError(f"flight must be a bool, an int ring capacity, or a FlightRecorder, got {flight!r}")


def _faults_section(events) -> dict:
    # the submodule's function by its full path: ``faults.inject`` is the
    # context manager (the JAX package's import gets that, so its bundles
    # never name the plan)
    from mpi_k_selection_tpu_torch.faults.inject import active_injector
    from mpi_k_selection_tpu_torch.obs.events import FaultEvent

    injector = active_injector()
    return {"events": [e.as_dict() for e in events if isinstance(e, FaultEvent)],
            "plan": None if injector is None else repr(injector.plan)}


def build_bundle(obs, *, reason: str = "on-demand", flight=None, extra=None) -> dict:
    """One debug bundle from whatever channels exist: without a flight
    channel the event and span tails are empty, and the five
    :data:`BUNDLE_SECTIONS` are always there."""
    from mpi_k_selection_tpu_torch.obs.ledger import LEDGER, collect_ledger

    if flight is None and obs is not None:
        flight = obs.flight
    events = flight.events_tail() if flight is not None else []
    spans = flight.spans_tail() if flight is not None else []
    metrics = {}
    if obs is not None and obs.metrics is not None:
        collect_ledger(obs.metrics)  # idempotent: the ledger gauges in every bundle
        metrics = obs.metrics.as_dict()
    span_rows = [{"name": name, "t0": t0, "t1": t1, "thread_id": tid, "thread": tname, "args": args}
                 for name, t0, t1, tid, tname, args in spans]
    bundle = {
        "reason": reason,
        "events": [e.as_dict() for e in events],
        "metrics": metrics,
        "ledger": LEDGER.snapshot(),
        "spans": {"tail": span_rows, "thread_tracks": len({r["thread_id"] for r in span_rows})},
        "faults": _faults_section(events),
        "lock_order": None,  # the lock-order sanitizer is the port's analysis (ROADMAP Queue 1 item 7)
    }
    if extra:
        bundle.update(extra)
    return bundle


def auto_dump(obs, reason: str, *, exc=None) -> str | None:
    """The hook the recovery surfaces call on a terminal failure (the
    descent's ladder on RetryExhaustedError or unrecoverable spill
    damage, the retry policies on exhaustion): one dump per recorder, a
    no-op without a flight channel. It never raises: a bundle that fails
    to write must not mask the typed error on its way out."""
    flight = None if obs is None else obs.flight
    if flight is None:
        return None
    try:
        return flight.maybe_auto_dump(reason, obs=obs, exc=exc)
    except Exception:  # the dump is best effort: the error that triggered it is already propagating
        return None
