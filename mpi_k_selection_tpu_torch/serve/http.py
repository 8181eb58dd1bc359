"""HTTP front of the query server, stdlib only, JSON in and out
(counterpart of ``mpi_k_selection_tpu/serve/http.py``, with its endpoints,
status codes and headers).

A thin shell over :class:`~mpi_k_selection_tpu_torch.serve.server.
KSelectServer`: this layer parses, serializes and maps typed errors to
status codes; every answer comes from the in-process API.

Endpoints:

- ``POST /v1/query``: body ``{"dataset": id, "op":
  "kselect"|"quantiles"|"topk"|"rank_certificate", ...}`` with ``k`` or
  ``ks`` (kselect), ``qs`` (quantiles), ``k`` and ``largest`` (topk),
  ``value`` (rank_certificate), an optional ``tier`` (sketch, exact or
  auto; default auto) and an optional ``deadline_ms``. Response:
  ``{"answers": [...]}`` for rank ops (each ``RankAnswer.as_dict``; sketch
  answers always carry their bounds), ``{"values": [...], "indices":
  [...]}`` for topk, ``{"less": L, "leq": E}`` for a certificate.
- ``GET /v1/datasets``: the registered datasets.
- ``GET /metrics``: the server's metrics as Prometheus text.
- ``GET /healthz``: liveness, the dataset count, ``fast_path`` and the
  live lane count.
- ``GET /debug/bundle``: the debug bundle (obs/flight.py).

Every response echoes the request's ``X-Ksel-Trace-Id`` (an inbound one
is honored, else one is minted). Errors: :class:`DatasetNotFoundError`
404, :class:`QueryError` / ``ValueError`` / ``TypeError`` 400,
:class:`ServerClosedError` 503, :class:`ServerOverloadedError` 503 with
``Retry-After``, :class:`DeadlineExceededError` 504, anything else 500
(its message included: an internal service, not a hardened edge).

Threading: a ``ThreadingHTTPServer`` whose request threads are named
``ksel-serve-req-*``, tracked and joined by ``server_close()``.
:func:`start_http_server` runs the accept loop on a ``ksel-serve-http-*``
thread and returns a handle whose ``close()`` shuts down, closes and joins
everything; the CLI's ``serve`` runs the loop on its main thread.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_k_selection_tpu_torch.serve.batcher import SERVE_THREAD_PREFIX
from mpi_k_selection_tpu_torch.serve.errors import (
    DatasetNotFoundError,
    DeadlineExceededError,
    QueryError,
    ServerClosedError,
    ServerOverloadedError,
)

#: Request-body ceiling: queries are tiny JSON; a megabyte is a client bug.
MAX_BODY_BYTES = 1 << 20


def _jsonable(v):
    item = getattr(v, "item", None)
    return item() if item is not None else v


class _Handler(BaseHTTPRequestHandler):
    server_version = "ksel-serve"
    protocol_version = "HTTP/1.1"

    # silence the default stderr access log: the obs registry (queue
    # depth, per-tier counters/latency) is this subsystem's telemetry
    # channel, and stray writes would interleave with CLI output
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    @property
    def kserver(self):
        return self.server.kserver

    # -- plumbing ----------------------------------------------------------

    def _request_trace_id(self) -> str:
        """The request-correlation id: an inbound ``X-Ksel-Trace-Id`` is honored verbatim (so a
        caller's id follows the query across services), else one is
        minted — either way every response echoes it, success and error
        alike, and the serve events/spans of the work it triggered carry
        the same id."""
        tid = getattr(self, "_trace_id", None)
        if tid is None:
            from mpi_k_selection_tpu_torch.serve.server import KSelectServer

            inbound = self.headers.get("X-Ksel-Trace-Id")
            tid = self._trace_id = KSelectServer._trace_id(inbound)
        return tid

    def _send(
        self, code: int, payload, *, content_type="application/json",
        headers=None,
    ):
        body = (
            payload
            if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload).encode()
        )
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Ksel-Trace-Id", self._request_trace_id())
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code: int, message: str, headers=None):
        # the trace id rides error BODIES too: a 504/503 postmortem
        # starts from the id the client logged
        self._send(
            code,
            {"error": message, "trace_id": self._request_trace_id()},
            headers=headers,
        )

    def _read_json(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length > MAX_BODY_BYTES:
            # the unread body would desync this HTTP/1.1 keep-alive
            # connection (the next parse would read body bytes as a
            # request line) — drop the connection after the error
            self.close_connection = True
            raise QueryError(f"request body exceeds {MAX_BODY_BYTES} bytes")
        raw = self.rfile.read(length) if length else b""
        if not raw:
            raise QueryError("empty request body; send a JSON query")
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise QueryError(f"bad JSON body: {e}") from e

    def _guarded(self, fn):
        try:
            fn()
        except DatasetNotFoundError as e:
            self._send_error_json(404, str(e))
        except (QueryError, ValueError, TypeError) as e:
            self._send_error_json(400, str(e))
        except DeadlineExceededError as e:
            self._send_error_json(504, str(e))
        except ServerOverloadedError as e:
            # shed by admission control: tell the client how long to back
            # off (integer ceiling — Retry-After is delta-seconds)
            self._send_error_json(
                503, str(e),
                headers={"Retry-After": str(max(1, int(-(-e.retry_after // 1))))},
            )
        except ServerClosedError as e:
            self._send_error_json(503, str(e))
        except Exception as e:  # internal service: surface, don't hide
            self._send_error_json(500, f"{type(e).__name__}: {e}")

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        # keep-alive reuses one handler across requests: re-resolve the
        # trace id per request, never per connection
        self._trace_id = None
        self._guarded(self._get)

    def _get(self):
        if self.path == "/healthz":
            self._send(
                200,
                {
                    "status": "ok",
                    "datasets": len(self.kserver.registry),
                    "fast_path": self.kserver.fast_path,
                    "lanes": self.kserver.batcher.lane_count,
                },
            )
        elif self.path == "/v1/datasets":
            self._send(200, {"datasets": self.kserver.list_datasets()})
        elif self.path == "/metrics":
            self._send(
                200,
                self.kserver.render_prometheus().encode(),
                content_type="text/plain; version=0.0.4; charset=utf-8",
            )
        elif self.path == "/debug/bundle":
            # the postmortem debug bundle (obs/flight.py; sections are
            # empty-but-present without a flight= channel) — default=str
            # absorbs any non-JSON leaf a span arg or plan repr carries
            self._send(
                200,
                json.dumps(
                    self.kserver.debug_bundle(reason="http"), default=str
                ).encode(),
            )
        else:
            self._send_error_json(404, f"unknown path {self.path!r}")

    def do_POST(self):
        self._trace_id = None
        self._guarded(self._post)

    def _post(self):
        if self.path != "/v1/query":
            self._send_error_json(404, f"unknown path {self.path!r}")
            return
        req = self._read_json()
        dataset = req.get("dataset")
        if not isinstance(dataset, str):
            raise QueryError("query needs a string 'dataset' id")
        op = req.get("op", "kselect")
        tier = req.get("tier", "auto")
        deadline = None
        if "deadline_ms" in req:
            raw_dl = req["deadline_ms"]
            try:
                if isinstance(raw_dl, bool):  # json true/false float()s to 1/0
                    raise TypeError("bool is not a duration")
                deadline = float(raw_dl) / 1000.0
            except (TypeError, ValueError) as e:
                raise QueryError(
                    f"deadline_ms must be a number of milliseconds, got "
                    f"{req['deadline_ms']!r}"
                ) from e
            # stdlib json parses NaN/Infinity: NaN would dodge the <= 0
            # guard and expire instantly, Infinity would never expire —
            # both are malformed requests, not deadlines
            if not math.isfinite(deadline) or deadline <= 0:
                raise QueryError("deadline_ms must be a finite number > 0")
        srv = self.kserver
        tid = self._request_trace_id()
        if op == "kselect":
            ks = req["ks"] if "ks" in req else [req["k"]] if "k" in req else None
            if ks is None:
                raise QueryError("kselect needs 'k' or 'ks'")
            answers = srv.kselect_many(
                dataset, ks, tier=tier, deadline=deadline, trace_id=tid
            )
            self._send(
                200,
                {
                    "dataset": dataset,
                    "op": op,
                    "trace_id": tid,
                    "answers": [a.as_dict() for a in answers],
                },
            )
        elif op == "quantiles":
            if "qs" not in req:
                raise QueryError("quantiles needs 'qs'")
            answers = srv.quantiles(
                dataset, req["qs"], tier=tier, deadline=deadline, trace_id=tid
            )
            self._send(
                200,
                {
                    "dataset": dataset,
                    "op": op,
                    "trace_id": tid,
                    "answers": [a.as_dict() for a in answers],
                },
            )
        elif op == "topk":
            if "k" not in req:
                raise QueryError("topk needs 'k'")
            values, indices = srv.topk(
                dataset, int(req["k"]), largest=bool(req.get("largest", True)),
                deadline=deadline, trace_id=tid,
            )
            self._send(
                200,
                {
                    "dataset": dataset,
                    "op": op,
                    "trace_id": tid,
                    "values": [_jsonable(v) for v in values],
                    "indices": [int(i) for i in indices],
                },
            )
        elif op == "rank_certificate":
            if "value" not in req:
                raise QueryError("rank_certificate needs 'value'")
            less, leq = srv.rank_certificate(
                dataset, req["value"], deadline=deadline, trace_id=tid
            )
            self._send(
                200,
                {
                    "dataset": dataset, "op": op, "trace_id": tid,
                    "less": int(less), "leq": int(leq),
                },
            )
        else:
            raise QueryError(
                f"unknown op {op!r}; choose from "
                "('kselect', 'quantiles', 'topk', 'rank_certificate')"
            )


class KSelectHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with named, tracked, joined request threads."""

    daemon_threads = False
    allow_reuse_address = True

    _ids = itertools.count()

    def __init__(self, address, kserver):
        super().__init__(address, _Handler)
        self.kserver = kserver
        self._req_lock = threading.Lock()
        self._req_threads: list[threading.Thread] = []  # ksel: guarded-by[_req_lock]
        self._serve_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def process_request(self, request, client_address):
        """Per-request thread with the serve prefix, tracked for the
        join in :meth:`server_close` (the stdlib mixin's anonymous
        ``Thread-N`` workers would outlive the server unseen)."""
        t = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name=f"{SERVE_THREAD_PREFIX}-req-{next(self._ids)}",
            daemon=False,
        )
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
        """Full shutdown: stop the accept loop, close the socket, join
        request threads and the serve-loop thread (when
        :func:`start_http_server` started one). Does NOT close the
        underlying KSelectServer — the caller owns it."""
        self.shutdown()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
            self._serve_thread = None

    def __enter__(self) -> "KSelectHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_server(
    kserver, *, host: str = "127.0.0.1", port: int = 0
) -> KSelectHTTPServer:
    """Bind and serve in the background (accept loop on a
    ``ksel-serve-http-*`` thread). ``port=0`` binds an ephemeral port —
    read it off ``handle.port``. ``handle.close()`` tears everything
    down; the caller still owns ``kserver.close()``."""
    httpd = KSelectHTTPServer((host, port), kserver)
    t = threading.Thread(
        target=httpd.serve_forever,
        kwargs={"poll_interval": 0.05},
        name=f"{SERVE_THREAD_PREFIX}-http-{next(KSelectHTTPServer._ids)}",
        daemon=True,
    )
    httpd._serve_thread = t
    t.start()
    return httpd
