"""Metrics registry: counters, gauges and histograms with JSON and
Prometheus-text exposition (counterpart of
``mpi_k_selection_tpu/obs/metrics.py``, with its metric names and labels).

The numbers half of the telemetry (obs/events.py is the shapes half):
StagingPool hits and misses, ``pipeline.stall`` seconds, in-flight window
occupancy, spilled bytes, chunks and bytes per ingest slot.

- Thread-safe: the pipelined descent records from the producer thread and
  the consumer at once; every mutation takes the registry's lock.
- Exact: counters and gauges are plain Python ints and floats, so a
  mirrored metric equals its source counter.
- Off by default: a registry exists only when the caller passes one (in
  an :class:`~mpi_k_selection_tpu_torch.obs.Observability`).

Exposition: :meth:`MetricsRegistry.as_dict`, :meth:`MetricsRegistry.to_json`
and :meth:`MetricsRegistry.render_prometheus` (text format 0.0.4: dots
become underscores, every name is prefixed ``ksel_``).
"""

from __future__ import annotations

import json
import math
import re
import threading

#: Default occupancy-style histogram buckets (small non-negative counts).
DEFAULT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: ``# HELP`` one-liners for the catalog metrics;
#: exposition emits HELP only for names listed here — an unlisted name
#: still renders conformant TYPE + sample lines.
HELP_TEXTS = {
    "ingest.chunks": "Chunks consumed per round-robin ingest slot",
    "ingest.bytes": "Key bytes consumed per round-robin ingest slot",
    "inflight.occupancy": "In-flight executor bundles at every windowed push",
    "staging_pool.hits": "StagingPool buffer reuse hits",
    "staging_pool.misses": "StagingPool buffer allocations",
    "staging_pool.resident_bytes": "Free-list bytes currently pooled",
    "spill.passes": "Spill store pass_log entries",
    "spill.disk_bytes_read": "Physical spill bytes read (packed/pruned)",
    "spill.disk_bytes_written": "Physical spill bytes written (packed)",
    "spill.packed_bytes": "Physical bytes resident in live generations",
    "spill.logical_bytes": "Logical key bytes resident in live generations",
    "ingest.resolved_bits": "Resolved key bits after each descent pass",
    "phase.seconds": "Wall seconds per PhaseTimer phase",
    "phase.calls": "Calls per PhaseTimer phase",
    "serve.queries": "Requests answered, by answering tier and op",
    "serve.latency_seconds": "Per-request wall latency by answering tier",
    "serve.queue_depth": "Per-lane dispatch-queue depth at every submit",
    "serve.batch_width": "Total rank width of each coalesced dispatch",
    "serve.fastpath": "Sketch-tier answers served on the request thread",
    "serve.warmup_compiles": "Programs pre-built by add_dataset warmup",
    "serve.lanes": "Dispatch lanes currently open (one per device)",
    "monitor.quantile": "Continuous windowed quantile stream (monitor/)",
    "monitor.window_n": "Merged live-window count of the monitor",
    "monitor.epoch": "Window advances completed by the monitor",
    "monitor.samples": "Samples the monitor has emitted",
}


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP-text escaping: backslash and newline only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(pairs) -> str:
    """``{k="v",...}`` with escaped values, '' for no labels."""
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(pairs)
    )
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: identity (name + sorted label pairs) and the
    registry lock every mutation runs under."""

    type_name = "untyped"

    def __init__(self, name: str, labels: tuple, lock: threading.Lock):
        self.name = name
        self.labels = labels  # sorted tuple of (key, value) pairs
        self._lock = lock

    def label_str(self) -> str:
        return _render_labels(self.labels)


class Counter(_Metric):
    """Monotone event count. ``set`` exists for COLLECTED mirrors of
    pre-existing counters (StagingPool.hits, a pass_log total) — the
    snapshot overwrites so repeated collections stay idempotent."""

    type_name = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def as_dict(self) -> dict:
        return {"type": self.type_name, "value": self.value}


class Gauge(_Metric):
    """Point-in-time value (seconds, occupancy, fraction)."""

    type_name = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self.value = 0

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n

    def as_dict(self) -> dict:
        return {"type": self.type_name, "value": self.value}


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` bounds,
    implicit ``+Inf``), plus exact count/sum/min/max."""

    type_name = "histogram"

    def __init__(self, name, labels, lock, buckets=DEFAULT_BUCKETS):
        super().__init__(name, labels, lock)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # ksel: guarded-by[_lock] (last = +Inf)
        self.count = 0
        self.sum = 0
        self.min = None
        self.max = None

    def observe(self, value) -> None:
        with self._lock:
            self._observe_locked(value)

    def _observe_locked(self, value) -> None:
        """Bookkeeping under the registry lock — the override point of
        the windowed-histogram bridge (obs/windows.py), which adds its
        sketch fold to the SAME critical section."""
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> list[int]:
        """Cumulative counts per ``le`` bound (+Inf last) — the
        Prometheus wire shape. Snapshots under the registry lock: an
        observe() racing this iteration would otherwise tear the
        monotone-bucket invariant (KSL015)."""
        with self._lock:
            return self._cumulative_locked()

    def _cumulative_locked(self) -> list[int]:
        """The raw accumulation — callers hold the registry lock (the
        exposition renderer snapshots buckets/count/sum in ONE critical
        section, so the +Inf bucket and _count lines agree)."""
        out, running = [], 0
        for c in self.bucket_counts:
            running += c
            out.append(running)
        return out

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def as_dict(self) -> dict:
        with self._lock:
            cum = self._cumulative_locked()
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
        return {
            "type": self.type_name,
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "mean": total / count if count else None,
            "buckets": {
                **{str(b): c for b, c in zip(self.bounds, cum)},
                "+Inf": count,
            },
        }


class MetricsRegistry:
    """Get-or-create home for every metric of one run (or one process).

    Metrics are keyed by ``(name, labels)``; asking for an existing key
    returns the same object, so library code can fetch by name at record
    time without plumbing metric handles around. One lock serializes all
    mutation — metric cardinality here is tiny (tens), contention is not
    a concern at chunk granularity.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}  # ksel: guarded-by[_lock]
        self._window_specs: dict = {}  # ksel: guarded-by[_lock]

    @staticmethod
    def _key(name: str, labels):
        lab = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
        return name, lab

    def _get_or_create(self, cls, name, labels, **kwargs):
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], self._lock, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.type_name}"
                )
            return m

    def counter(self, name: str, labels=None) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, labels=None, buckets=DEFAULT_BUCKETS) -> Histogram:
        spec = self._window_specs.get(name)
        if spec is not None:
            from mpi_k_selection_tpu_torch.obs.windows import WindowedHistogram

            return self._get_or_create(
                WindowedHistogram, name, labels, buckets=buckets, **spec
            )
        return self._get_or_create(Histogram, name, labels, buckets=buckets)

    def enable_windowed(
        self, name: str, *, window: int = 8, advance_every: int = 256,
        radix_bits: int = 4, levels: int = 4, decay: float | None = None,
        quantiles=(0.5, 0.9, 0.99),
    ) -> None:
        """Back every future labeled series of histogram ``name`` with a
        sliding-window RadixSketch (obs/windows.py): observations fold
        into per-``advance_every``-observation window buckets, and the
        exposition gains exactly-bounded ``<name>_windowed`` quantile
        gauges next to the unchanged fixed-bucket series. Must run
        BEFORE the metric's first creation — an already-created plain
        histogram cannot be upgraded retroactively (its past
        observations are gone), so that raises instead of silently
        serving a half-empty window."""
        with self._lock:
            existing = [k for k in self._metrics if k[0] == name]
            if existing:
                raise TypeError(
                    f"metric {name!r} already has {len(existing)} series; "
                    "enable_windowed must run before the first observation"
                )
            self._window_specs[name] = dict(
                window=window, advance_every=advance_every,
                radix_bits=radix_bits, levels=levels, decay=decay,
                quantiles=tuple(quantiles),
            )

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- exposition --------------------------------------------------------

    def as_dict(self) -> dict:
        """``{name or name{labels}: metric dict}`` — the JSON-ready
        snapshot bench records and ``--metrics-json`` embed."""
        out = {}
        for m in self.metrics():
            out[m.name + m.label_str()] = m.as_dict()
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): names sanitized to
        ``ksel_<name_with_underscores>``, HELP lines for cataloged
        names, label values escaped per the grammar, histograms as
        ``_bucket{le=...}``/``_sum``/``_count`` series — plus, for
        windowed histograms (obs/windows.py), the exactly-bounded
        ``_windowed``/``_windowed_rank_error``/``_windowed_count``
        quantile gauges."""
        by_name: dict = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            group = sorted(by_name[name], key=lambda g: g.labels)
            pname = "ksel_" + _NAME_RE.sub("_", name.replace(".", "_"))
            if name in HELP_TEXTS:
                lines.append(f"# HELP {pname} {_escape_help(HELP_TEXTS[name])}")
            lines.append(f"# TYPE {pname} {group[0].type_name}")
            windowed = []  # (labels, snapshot) per windowed member
            for m in group:
                if isinstance(m, Histogram):
                    # one consistent snapshot under the lock: the +Inf
                    # bucket and _count lines must agree, and a scrape
                    # racing a live observe() would otherwise read
                    # m.count twice across the interleaving
                    with m._lock:
                        cum = m._cumulative_locked()
                        count, total = m.count, m.sum
                    for bound, c in zip(m.bounds, cum):
                        lab = dict(m.labels)
                        lab["le"] = _format_float(bound)
                        lines.append(
                            f"{pname}_bucket{_render_labels(lab.items())} {c}"
                        )
                    inf_lab = dict(m.labels)
                    inf_lab["le"] = "+Inf"
                    lines.append(
                        f"{pname}_bucket{_render_labels(inf_lab.items())} "
                        f"{count}"
                    )
                    lines.append(f"{pname}_sum{m.label_str()} {_format_float(total)}")
                    lines.append(f"{pname}_count{m.label_str()} {count}")
                    snapshot = getattr(m, "windowed_snapshot", None)
                    if snapshot is not None:
                        snap = snapshot()
                        if snap is not None:
                            windowed.append((m.labels, snap))
                else:
                    lines.append(
                        f"{pname}{m.label_str()} {_format_float(m.value)}"
                    )
            if windowed:
                lines.append(
                    f"# HELP {pname}_windowed Sliding-window quantile with "
                    "exact rank/value bounds (obs/windows.py)"
                )
                lines.append(f"# TYPE {pname}_windowed gauge")
                for labels, snap in windowed:
                    for e in snap["quantiles"]:
                        lab = dict(labels)
                        lab["quantile"] = _format_float(e["q"])
                        lines.append(
                            f"{pname}_windowed{_render_labels(lab.items())} "
                            f"{_format_float(e['value'])}"
                        )
                lines.append(f"# TYPE {pname}_windowed_rank_error gauge")
                for labels, snap in windowed:
                    for e in snap["quantiles"]:
                        lab = dict(labels)
                        lab["quantile"] = _format_float(e["q"])
                        lines.append(
                            f"{pname}_windowed_rank_error"
                            f"{_render_labels(lab.items())} "
                            f"{e['rank_error']}"
                        )
                lines.append(f"# TYPE {pname}_windowed_count gauge")
                for labels, snap in windowed:
                    lines.append(
                        f"{pname}_windowed_count{_render_labels(labels)} "
                        f"{snap['n']}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _format_float(v) -> str:
    """Prometheus value formatting: ints stay integral, floats drop the
    trailing noise, infinities spell +Inf/-Inf."""
    if isinstance(v, bool):  # pragma: no cover - no bool metrics exist
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def collect_runtime(
    registry: MetricsRegistry,
    *,
    staging_pool=None,
    spill_store=None,
    timer=None,
) -> MetricsRegistry:
    """Snapshot the repo's pre-existing runtime counters into ``registry``
    — the ONE mapping from internal state to exported metric names, so
    the values are the originals by construction:

    - ``staging_pool.hits`` / ``staging_pool.misses`` (Counter) and
      ``staging_pool.resident_bytes`` (Gauge) from a
      :class:`~mpi_k_selection_tpu_torch.streaming.pipeline.StagingPool`;
    - ``spill.passes`` / ``spill.bytes_read`` / ``spill.bytes_written`` /
      ``spill.keys_read`` / ``spill.keys_written`` (Counter) summed over a
      :class:`~mpi_k_selection_tpu_torch.streaming.spill.SpillStore`'s
      ``pass_log``, their PHYSICAL twins ``spill.disk_bytes_read`` /
      ``spill.disk_bytes_written`` (what the packed/pruned records
      actually moved on disk vs the logical keys-x-itemsize columns),
      plus ``spill.generations_live`` and the resident-footprint pair
      ``spill.packed_bytes`` / ``spill.logical_bytes`` (Gauge — equal
      unless ``pack_spill`` shrank the on-disk records);
    - every :class:`~mpi_k_selection_tpu_torch.utils.profiling.PhaseTimer`
      phase as ``phase.seconds{phase=...}`` / ``phase.calls{phase=...}``
      (the ``pipeline.stall`` seconds the ROADMAP items need ride here).

    Snapshots overwrite (``Counter.set``), so collecting twice is
    idempotent. Returns ``registry``.
    """
    if staging_pool is not None:
        registry.counter("staging_pool.hits").set(int(staging_pool.hits))
        registry.counter("staging_pool.misses").set(int(staging_pool.misses))
        registry.gauge("staging_pool.resident_bytes").set(
            int(staging_pool.resident_bytes)
        )
    if spill_store is not None:
        log = list(spill_store.pass_log)
        registry.counter("spill.passes").set(len(log))
        registry.counter("spill.bytes_read").set(
            sum(int(p.get("bytes_read", 0)) for p in log)
        )
        registry.counter("spill.keys_read").set(
            sum(int(p.get("keys_read", 0)) for p in log)
        )
        registry.counter("spill.bytes_written").set(
            sum(int(p.get("bytes_written", 0)) for p in log)
        )
        registry.counter("spill.keys_written").set(
            sum(int(p.get("keys_written", 0)) for p in log)
        )
        registry.counter("spill.disk_bytes_read").set(
            sum(int(p.get("disk_bytes_read") or 0) for p in log)
        )
        registry.counter("spill.disk_bytes_written").set(
            sum(int(p.get("disk_bytes_written") or 0) for p in log)
        )
        gens = getattr(spill_store, "generations", {})
        registry.gauge("spill.generations_live").set(len(gens))
        live = list(gens.values()) if hasattr(gens, "values") else list(gens)
        registry.gauge("spill.packed_bytes").set(
            sum(int(g.nbytes) for g in live)
        )
        registry.gauge("spill.logical_bytes").set(
            sum(int(getattr(g, "logical_nbytes", g.nbytes)) for g in live)
        )
    if timer is not None:
        for name, d in timer.as_dict().items():
            registry.gauge("phase.seconds", labels={"phase": name}).set(  # ksel: noqa[KSL013] -- phase names are a closed, code-defined set (PhaseTimer phases), not per-request data
                d["seconds"]
            )
            registry.gauge("phase.calls", labels={"phase": name}).set(d["calls"])  # ksel: noqa[KSL013] -- phase names are a closed, code-defined set (PhaseTimer phases), not per-request data
    return registry
