"""Telemetry of the streamed descent and the selection entry points
(counterpart of ``mpi_k_selection_tpu/obs/``): structured events,
metrics and cross-thread tracing, with the JAX package's event kinds,
fields, metric names and labels.

One :class:`Observability` bundle carries up to four channels:

- **events** (obs/events.py): per pass and per chunk observations of the
  exact descent (active prefixes, survivor populations, bytes streamed,
  the chunk -> device slot, spill generation sizes);
- **metrics** (obs/metrics.py): counters, gauges and histograms (StagingPool
  hits and misses, ``pipeline.stall`` seconds, in-flight window occupancy,
  spilled bytes, chunks per slot) with JSON and Prometheus-text exposition;
- **trace** (obs/trace.py): producer and consumer host spans as Chrome
  trace-event JSON, over utils/profiling.py:``PhaseTimer``. The same
  phases, and the resident paths' ``ksel.*`` spans
  (utils/profiling.py:``span``), also land in any ``torch.profiler``
  trace (the CLI's ``--trace-dir``) as ``record_function`` ranges on the
  kernels' clock; with the profiler off and no timer a span is one
  shared null context (one C call, no allocation);
- **flight** (obs/flight.py): a bounded ring of the recent events and spans
  that a terminal failure (or ``--debug-bundle``) dumps as a JSON debug
  bundle.

Everything is off by default: the entry points take ``obs=None`` and
guard every emission behind that check, and no channel changes an answer
bit. Usage::

    from mpi_k_selection_tpu_torch import obs as obs_lib

    o = obs_lib.Observability.collecting()
    v = kt.kselect_streaming(source, k, obs=o)
    o.events.of_kind("stream.pass")        # the typed event stream
    o.metrics.render_prometheus()          # exposition text
    o.trace.write("trace.json")            # open in perfetto

CLI: ``--metrics-json``, ``--trace-events`` and ``--debug-bundle``.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.obs.events import (
    CallbackSink,
    CertificateEvent,
    ChunkEvent,
    DistributedSelectEvent,
    EventSink,
    FaultEvent,
    ListSink,
    ObsEvent,
    RecompileStormEvent,
    ResidentSelectEvent,
    ServeBatchEvent,
    ServeQueryEvent,
    SketchPassEvent,
    SpillGenerationEvent,
    StreamPassEvent,
    check_stream_invariants,
)
from mpi_k_selection_tpu_torch.obs.flight import FlightRecorder, build_bundle, resolve_flight
from mpi_k_selection_tpu_torch.obs.ledger import (
    LEDGER,
    ProgramLedger,
    collect_ledger,
    ledger_dispatch,
    snapshot_delta,
)
from mpi_k_selection_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    collect_runtime,
)
from mpi_k_selection_tpu_torch.obs.trace import Span, TraceRecorder
from mpi_k_selection_tpu_torch.obs.windows import WindowedHistogram

__all__ = [
    "CallbackSink",
    "CertificateEvent",
    "ChunkEvent",
    "Counter",
    "DistributedSelectEvent",
    "EventSink",
    "FaultEvent",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LEDGER",
    "ListSink",
    "MetricsRegistry",
    "Observability",
    "ObsEvent",
    "ProgramLedger",
    "RecompileStormEvent",
    "ResidentSelectEvent",
    "ServeBatchEvent",
    "ServeQueryEvent",
    "SketchPassEvent",
    "Span",
    "SpillGenerationEvent",
    "StreamPassEvent",
    "TraceRecorder",
    "WindowedHistogram",
    "build_bundle",
    "check_stream_invariants",
    "collect_ledger",
    "collect_runtime",
    "ledger_dispatch",
    "resolve_flight",
    "snapshot_delta",
]

class Observability:
    """The telemetry bundle the entry points take as ``obs=``. Any subset
    of channels may be on; a None channel costs one attribute check at
    each emission site. Every channel is thread-safe: the pipelined
    descent records from the producer and the consumer at once.

    ``flight`` (obs/flight.py: ``resolve_flight``'s forms) is the fourth,
    postmortem channel: a bounded ring that shares the event stream (every
    ``emit`` fans into it) and keeps the recent tail for a debug bundle."""

    def __init__(self, *, events=None, metrics=None, trace=None, flight=None):
        self.events = events
        self.metrics = metrics
        self.trace = trace
        self.flight = resolve_flight(flight)

    @classmethod
    def collecting(cls, *, flight=False) -> "Observability":
        """Every live channel on, in memory: a ListSink, a fresh
        MetricsRegistry and a TraceRecorder; ``flight`` (True, an int ring
        capacity or a FlightRecorder) adds the postmortem ring."""
        return cls(events=ListSink(), metrics=MetricsRegistry(), trace=TraceRecorder(), flight=flight or None)

    def emit(self, event: ObsEvent) -> None:
        """Send one event to the sink and the flight ring (a no-op without
        either)."""
        if self.events is not None:
            self.events.emit(event)
        if self.flight is not None:
            self.flight.record_event(event)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        on = [name for name in ("events", "metrics", "trace", "flight") if getattr(self, name) is not None]
        return f"Observability({', '.join(on) or 'all channels off'})"
