"""Cross-thread span tracing: Chrome trace-event export over PhaseTimer
(counterpart of ``mpi_k_selection_tpu/obs/trace.py``).

``torch.profiler`` (utils/profiling.py:``trace``, the CLI's
``--trace-dir``) sees the kernels and copies but not the host threads the
streamed passes live on: a producer thread (produce / encode / stage /
spill) overlapping the consumer (stall / pass / collect). This module
records those spans and exports them as Chrome trace-event JSON
(``traceEvents``), one track per thread, loadable in
https://ui.perfetto.dev or ``chrome://tracing``.

The recorder never reads a clock: :class:`~mpi_k_selection_tpu_torch.
utils.profiling.PhaseTimer` timestamps each phase and, with a recorder
attached, hands the finished ``(name, t0, t1)`` over on the thread that
ran it; the recorder adds the thread's identity.

These spans carry ``perf_counter`` times rebased to the earliest one, so
they do not line up with a kernel. To see them beside the kernels, trace
under ``torch.profiler`` (``--trace-dir``): while it records, every
``PhaseTimer`` phase and every ``ksel.*`` span of the resident paths
(utils/profiling.py:``span``) is also a ``record_function`` range there,
on the profiler's clock. Off, a span costs one C call.
"""

from __future__ import annotations

import dataclasses
import json
import threading


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed phase on one thread (times are perf_counter seconds,
    a shared monotonic base across threads of one process). ``args`` is
    optional span context a phase attached; it rides into the Chrome
    trace's ``args`` field."""

    name: str
    t0: float
    t1: float
    thread_id: int
    thread_name: str
    args: dict | None = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class TraceRecorder:
    """Thread-safe span collector + Chrome trace-event exporter.

    Attach to any :class:`~mpi_k_selection_tpu_torch.utils.profiling.PhaseTimer`
    (``PhaseTimer(recorder=rec)``); one recorder may serve several timers
    (e.g. the CLI's solve timer and the pipeline timer), interleaving
    their spans on the shared timeline.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: list[Span] = []  # ksel: guarded-by[_lock]

    def record(self, name: str, t0: float, t1: float, args=None) -> None:
        """Called by PhaseTimer on the thread that ran the phase."""
        t = threading.current_thread()
        span = Span(name, t0, t1, t.ident or 0, t.name, args)
        with self._lock:
            self.spans.append(span)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)

    def thread_ids(self) -> set[int]:
        """Distinct thread tracks recorded — a pipelined streaming run
        shows >= 2 (producer + consumer)."""
        return {s.thread_id for s in self.snapshot()}

    def to_chrome_trace(self, *, pid: int = 1) -> dict:
        """The Chrome trace-event JSON object: complete (``"X"``) events
        in microseconds rebased to the earliest span, plus
        ``thread_name`` metadata events so Perfetto labels each track
        (``ksel-pipeline-*`` = producer, ``MainThread`` = consumer)."""
        spans = self.snapshot()
        base = min((s.t0 for s in spans), default=0.0)
        events = []
        named: set[int] = set()
        for s in spans:
            if s.thread_id not in named:
                named.add(s.thread_id)
                events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": s.thread_id,
                        "args": {"name": s.thread_name},
                    }
                )
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "pid": pid,
                    "tid": s.thread_id,
                    "ts": (s.t0 - base) * 1e6,
                    "dur": s.duration * 1e6,
                    "cat": s.name.split(".")[0],
                    "args": dict(s.args) if s.args else {},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_chrome_trace(), indent=indent)

    def write(self, path: str) -> None:
        """Write the Chrome trace JSON to ``path`` (open it at
        https://ui.perfetto.dev or chrome://tracing)."""
        with open(path, "w") as f:
            f.write(self.to_json())
