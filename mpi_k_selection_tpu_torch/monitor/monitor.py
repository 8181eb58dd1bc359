"""Monitor: continuous multirank quantiles over an unbounded chunk stream
(counterpart of ``mpi_k_selection_tpu/monitor/monitor.py``).

The monitor reads any chunk source the streaming paths take, one-shot
iterators included (it reads its stream once), through the same staging
as the streamed descent (streaming/pipeline.py), and folds each chunk into
the window's open bucket with one launch of the sweep kernel's sketch part
on the card (streaming/executor.py:``SketchFoldConsumer``). Every
``emit_every`` chunks the window advances and one :class:`MonitorSample`
comes out: the requested quantiles (default p50/p90/p99) over the live
window, each with the merged sketch's exact rank and value bounds; with
``decay``, over the fixed-point decayed aggregate (monitor/decay.py).
``devices`` spreads the pipelined staging over cards as the streamed
descent does, and ``obs`` mirrors each sample into the ``monitor.*``
series, which :func:`start_metrics_server` serves as Prometheus text
(``GET /metrics``; the CLI's ``monitor --prometheus-port``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mpi_k_selection_tpu_torch import resource_protocols as _rp
from mpi_k_selection_tpu_torch.monitor.decay import DecayedWindowedSketch
from mpi_k_selection_tpu_torch.monitor.windows import WindowedSketch
from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
from mpi_k_selection_tpu_torch.streaming.sketch import reject_later_knobs
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

DEFAULT_QS = (0.5, 0.9, 0.99)

#: The prefix of the metrics exporter's threads (resource_protocols.py): in
#: the ``ksel-`` family the test suite's leaked-thread check covers;
#: ``close()`` joins them all.
MONITOR_THREAD_PREFIX = _rp.MONITOR_THREAD_PREFIX


def q_label(q: float) -> str:
    """Percentile label of a quantile: ``0.5 -> "p50"``, ``0.99 ->
    "p99"``, ``0.999 -> "p99_9"``."""
    s = format(float(q) * 100, "g").replace(".", "_")
    return f"p{s}"


def _jsonable(v):
    item = getattr(v, "item", None)
    return item() if item is not None else v


@dataclasses.dataclass(frozen=True)
class MonitorSample:
    """One window advance's readout. ``n`` is the merged window's count,
    weighted (on the ``scale`` fixed point) when decayed; the bounds are
    the sketch's exact guarantees in that count space."""

    epoch: int
    buckets: int
    n: int
    scale: int
    qs: tuple
    ranks: tuple
    values: tuple
    rank_bounds: tuple
    value_bounds: tuple
    rank_error_bounds: tuple
    chunks: int
    keys_read: int

    @property
    def metric_name(self) -> str:
        """``multirank_p50_p90_p99`` for the default quantiles."""
        return "multirank_" + "_".join(q_label(q) for q in self.qs)

    def as_dict(self) -> dict:
        return {
            "metric": self.metric_name,
            "epoch": self.epoch,
            "buckets": self.buckets,
            "n": int(self.n),
            "scale": int(self.scale),
            "qs": [float(q) for q in self.qs],
            "ranks": [int(k) for k in self.ranks],
            "values": [_jsonable(v) for v in self.values],
            "rank_bounds": [[int(a), int(b)] for a, b in self.rank_bounds],
            "value_bounds": [[_jsonable(a), _jsonable(b)] for a, b in self.value_bounds],
            "rank_error_bounds": [int(e) for e in self.rank_error_bounds],
            "chunks": self.chunks,
            "keys_read": self.keys_read,
        }

    def format_line(self) -> str:
        """One human-readable line of the stream."""
        parts = [f"{self.metric_name} epoch={self.epoch} buckets={self.buckets} n={self.n}"]
        for q, v, (vlo, vhi), err in zip(self.qs, self.values, self.value_bounds, self.rank_error_bounds):
            parts.append(f"{q_label(q)}={_jsonable(v)} in [{_jsonable(vlo)}, {_jsonable(vhi)}] rank_err<={err}")
        return "  ".join(parts)


class Monitor:
    """Continuous quantile monitoring over an unbounded stream.

    ``qs`` (any rank set; default p50/p90/p99), ``window`` (the ring's
    length in buckets), ``emit_every`` (chunks a bucket: the window
    advances and a sample comes out every that many chunks), ``decay``
    (None: the exact sliding window; a float in (0, 1]: the fixed-point
    decay of monitor/decay.py), and the staging knobs ``pipeline_depth``,
    ``ingest_workers``, ``device`` (where the buckets count, default
    ``"cuda"``; ``ingest_workers`` > 1 stages on the pooled host data
    plane, streaming/pipeline.py)
    and ``devices``. Samples are the same at every depth and slot count.
    ``obs`` mirrors each sample into ``monitor.quantile{q=}``,
    ``monitor.window_n``, ``monitor.epoch`` and ``monitor.samples``, and
    records the run's chunk events; it never changes a count bit."""

    def __init__(self, *, qs=DEFAULT_QS, window: int = 32, emit_every: int = 1, decay: float | None = None,
                 radix_bits: int = 4, levels: int = 4, pipeline_depth=None, ingest_workers=None, device=None,
                 devices=None, obs=None, **kwargs):
        reject_later_knobs("Monitor.__init__", kwargs)
        self.qs = tuple(float(q) for q in qs)
        if not self.qs:
            raise ValueError("monitor needs at least one quantile")
        self.window = int(window)
        self.emit_every = int(emit_every)
        if self.emit_every < 1:
            raise ValueError(f"emit_every must be >= 1, got {emit_every}")
        self.decay = None if decay is None else float(decay)
        self.radix_bits = int(radix_bits)
        self.levels = int(levels)
        self.pipeline_depth = pipeline_depth
        self.ingest_workers = ingest_workers
        self.device = device
        self.devices = devices
        self.obs = obs
        # the label dicts are the monitor's fixed configuration, built once
        self._q_labels = tuple({"q": q_label(q)} for q in self.qs)
        self.ws: WindowedSketch | None = None

    def _make_window(self, dtype) -> WindowedSketch:
        if self.decay is None:
            return WindowedSketch(dtype, window=self.window, radix_bits=self.radix_bits, levels=self.levels,
                                  device=self.device)
        return DecayedWindowedSketch(dtype, window=self.window, decay=self.decay, radix_bits=self.radix_bits,
                                     levels=self.levels, device=self.device)

    def sample(self, chunks: int = 0, keys_read: int = 0) -> MonitorSample | None:
        """One readout of the current window (None while it is empty): the
        per-advance emission, also callable alone."""
        ws = self.ws
        if ws is None:
            return None
        m = ws.query()
        if m.n == 0:
            return None
        from mpi_k_selection_tpu_torch.api import quantile_ranks

        ranks = quantile_ranks(self.qs, m.n)
        values, rbounds, vbounds, rerrs = [], [], [], []
        for k in ranks:
            lo, hi = m.rank_bounds(k)
            vlo, vhi = m.value_bounds(k)
            values.append(m.query(k))
            rbounds.append((lo, hi))
            vbounds.append((vlo, vhi))
            rerrs.append(hi - lo)
        out = MonitorSample(
            epoch=ws.epoch, buckets=ws.n_live, n=m.n, scale=getattr(m, "scale", 1), qs=self.qs,
            ranks=tuple(int(k) for k in ranks), values=tuple(values), rank_bounds=tuple(rbounds),
            value_bounds=tuple(vbounds), rank_error_bounds=tuple(rerrs), chunks=chunks, keys_read=keys_read,
        )
        if self.obs is not None and self.obs.metrics is not None:
            reg = self.obs.metrics
            for lab, v in zip(self._q_labels, values):
                reg.gauge("monitor.quantile", labels=lab).set(_jsonable(v))
            reg.gauge("monitor.window_n").set(int(m.n))
            reg.gauge("monitor.epoch").set(int(ws.epoch))
            reg.counter("monitor.samples").inc()
        return out

    def run(self, source, dtype=None, *, max_samples=None, timer=None):
        """Generator of :class:`MonitorSample`: one a window advance (and a
        last one for a partial bucket at the stream's end), until the
        source ends or ``max_samples`` came out. ``dtype`` is the stream's
        (taken from a list, tuple or array source; needed for a generator
        or a callable, which a monitor cannot replay to probe). The staging
        is torn down on every exit, an abandoned generator included.
        ``timer`` times the run's ``monitor.pass``."""
        from mpi_k_selection_tpu_torch.obs import metrics as _om
        from mpi_k_selection_tpu_torch.obs import wiring as _wr
        from mpi_k_selection_tpu_torch.streaming import chunked as _chunked
        from mpi_k_selection_tpu_torch.streaming import executor as _ex
        from mpi_k_selection_tpu_torch.utils.profiling import phase as _phase

        if dtype is None:
            if isinstance(source, (list, tuple)) and len(source):
                first = source[0]
                dtype = first.dtype if isinstance(first, torch.Tensor) else np.asarray(first).dtype
            elif isinstance(source, (np.ndarray, torch.Tensor)):
                dtype = source.dtype
            else:
                raise TypeError(
                    "pass dtype= for generator/callable sources: the "
                    "monitor folds chunks as they arrive and cannot "
                    "replay the stream to probe its dtype"
                )
        depth = _pl.validate_pipeline_depth(self.pipeline_depth)
        pool_n = _pl.resolve_ingest_workers(self.ingest_workers)
        dev, devs = _pl.resolve_ingest(self.device, self.devices)
        # staging to slots is gated on the knobs as given, as the JAX package's
        staged = depth > 0 and self.devices is not None
        obs = self.obs
        self.ws = self._make_window(dtype)
        kdt = np.dtype(f"uint{_dt.key_bits(self.ws.dtype)}")
        src = _chunked.as_chunk_source(source, one_shot_ok=True)
        timer, restore = _wr.attach_timer(obs, timer)
        consumer = _ex.SketchFoldConsumer(self.ws.current, obs=obs, phase="monitor")
        ex = _ex.StreamExecutor([consumer], window=len(devs) if staged else 1,
                                occupancy=_wr.window_occupancy(obs, phase="monitor"))
        chunk_i = keys_read = emitted = in_bucket = 0
        keys = None
        try:
            with _phase(timer, "monitor.pass"), _chunked._key_chunk_stream(
                src, _dt.torch_dtype(self.ws.dtype), pipeline_depth=depth, device=dev, devs=devs, staged=staged,
                window=len(devs) if staged else 1, timer=timer, workers=pool_n,
            ) as chunks:
                for keys, _ in chunks:
                    if obs is not None:
                        _wr.chunk_event(obs, "monitor", chunk_i, keys, kdt, devs)
                    chunk_i += 1
                    keys_read += keys.size
                    in_bucket += 1
                    consumer.sketch = self.ws.current  # the open bucket
                    ex.push(keys)
                    if in_bucket >= self.emit_every:
                        ex.drain()  # a bucket's chunks have folded before it closes
                        s = self.sample(chunk_i, keys_read)
                        if s is not None:
                            emitted += 1
                            yield s
                        self.ws.advance()
                        in_bucket = 0
                        if max_samples is not None and emitted >= max_samples:
                            break
                else:
                    ex.drain()
                    if in_bucket:
                        s = self.sample(chunk_i, keys_read)
                        if s is not None:
                            yield s
        except BaseException:
            ex.abort()
            _ex.release_staged(keys)  # the chunk in hand (idempotent)
            raise
        finally:
            restore()
        if obs is not None and obs.metrics is not None:
            _om.collect_runtime(obs.metrics, staging_pool=_pl.STAGING_POOL, timer=timer)


class _MetricsHandler(BaseHTTPRequestHandler):
    server_version = "ksel-monitor"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - the stdlib's signature
        pass  # the registry is the telemetry channel: no stderr chatter

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            self._send(200, self.server.registry.render_prometheus().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/healthz":
            self._send(200, b'{"status": "ok"}', "application/json")
        else:
            self._send(404, b"not found; GET /metrics or /healthz", "text/plain")


class MetricsHTTPServer(ThreadingHTTPServer):
    """The Prometheus text exposition of a MetricsRegistry: ``GET
    /metrics`` renders the registry live (``GET /healthz`` answers ok).
    The accept loop runs on ``ksel-monitor-http-*`` and each request on a
    ``ksel-monitor-req-*`` thread; :meth:`close` (or leaving the ``with``
    block) stops the loop, closes the socket and joins every thread."""

    daemon_threads = False
    allow_reuse_address = True

    _ids = itertools.count()

    def __init__(self, address, registry):
        super().__init__(address, _MetricsHandler)
        self.registry = registry
        self._req_lock = threading.Lock()
        self._req_threads: list[threading.Thread] = []  # ksel: guarded-by[_req_lock]
        self._serve_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def process_request(self, request, client_address):
        t = threading.Thread(target=self.process_request_thread, args=(request, client_address),
                             name=f"{MONITOR_THREAD_PREFIX}-req-{next(self._ids)}", daemon=False)
        with self._req_lock:
            self._req_threads = [x for x in self._req_threads if x.is_alive()]
            self._req_threads.append(t)
        t.start()

    def server_close(self):
        super().server_close()
        with self._req_lock:
            threads, self._req_threads = self._req_threads, []
        for t in threads:
            t.join(timeout=10.0)

    def close(self):
        """Stop the accept loop, close the socket, join every thread."""
        self.shutdown()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
            self._serve_thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(registry, *, host: str = "127.0.0.1", port: int = 0) -> MetricsHTTPServer:
    """Serve ``registry``'s Prometheus text exposition in the background
    (``port=0`` binds a free port: read ``handle.port``); ``handle.close()``
    tears it all down."""
    httpd = MetricsHTTPServer((host, port), registry)
    t = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         name=f"{MONITOR_THREAD_PREFIX}-http-{next(MetricsHTTPServer._ids)}", daemon=True)
    httpd._serve_thread = t
    t.start()
    return httpd
