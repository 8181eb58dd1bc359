"""Telemetry of the streamed descent and the selection entry points
(counterpart of ``mpi_k_selection_tpu/obs/``): structured events,
metrics and cross-thread tracing, with the JAX package's event kinds,
fields, metric names and labels.

One :class:`Observability` bundle carries up to three channels:

- **events** (obs/events.py): per pass and per chunk observations of the
  exact descent (active prefixes, survivor populations, bytes streamed,
  the chunk -> device slot, spill generation sizes);
- **metrics** (obs/metrics.py): counters, gauges and histograms (StagingPool
  hits and misses, ``pipeline.stall`` seconds, in-flight window occupancy,
  spilled bytes, chunks per slot) with JSON and Prometheus-text exposition;
- **trace** (obs/trace.py): producer and consumer host spans as Chrome
  trace-event JSON, over utils/profiling.py:``PhaseTimer``.

Everything is off by default: the entry points take ``obs=None`` and
guard every emission behind that check, and no channel changes an answer
bit. Usage::

    from mpi_k_selection_tpu_torch import obs as obs_lib

    o = obs_lib.Observability.collecting()
    v = kt.kselect_streaming(source, k, obs=o)
    o.events.of_kind("stream.pass")        # the typed event stream
    o.metrics.render_prometheus()          # exposition text
    o.trace.write("trace.json")            # open in perfetto

CLI: ``--metrics-json`` and ``--trace-events``. The JAX package's fourth
channel, the flight recorder (``flight=``), comes with the fault harness
(ROADMAP Queue 1 item 4).
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
    "check_stream_invariants",
    "collect_ledger",
    "collect_runtime",
    "ledger_dispatch",
    "snapshot_delta",
]

#: Why ``flight=`` is refused: the flight recorder ships with the faults.
FLIGHT_LATER = "the flight recorder is not ported yet (faults, ROADMAP Queue 1 item 4)"


class Observability:
    """The telemetry bundle the entry points take as ``obs=``. Any subset
    of channels may be on; a None channel costs one attribute check at
    each emission site. Every channel is thread-safe: the pipelined
    descent records from the producer and the consumer at once."""

    def __init__(self, *, events=None, metrics=None, trace=None, flight=None):
        if flight:
            raise TypeError(f"Observability(flight=...): {FLIGHT_LATER}")
        self.events = events
        self.metrics = metrics
        self.trace = trace
        self.flight = None

    @classmethod
    def collecting(cls, *, flight=False) -> "Observability":
        """Every live channel on, in memory: a ListSink, a fresh
        MetricsRegistry and a TraceRecorder."""
        if flight:
            raise TypeError(f"Observability.collecting(flight=...): {FLIGHT_LATER}")
        return cls(events=ListSink(), metrics=MetricsRegistry(), trace=TraceRecorder())

    def emit(self, event: ObsEvent) -> None:
        """Send one event to the sink (a no-op without one)."""
        if self.events is not None:
            self.events.emit(event)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        on = [name for name in ("events", "metrics", "trace") if getattr(self, name) is not None]
        return f"Observability({', '.join(on) or 'all channels off'})"
