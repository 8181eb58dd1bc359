"""Cross-request batcher: one dispatch thread, a bounded coalescing window
(counterpart of ``mpi_k_selection_tpu/serve/batcher.py``).

Many clients send small rank queries against one resident dataset; the
cheapest shape for that is one shared-pass ``kselect_many`` walk
(ops/radix.py shares every histogram pass across the ranks, and
``api.many_sort_dispatch_queries`` says when a wide batch should take the
cached sort instead). This module turns concurrent arrivals into that
shape:

- **One dispatch thread a batcher** (``ksel-serve-dispatch-*``, or a lane
  name when serve/lanes.py owns it) owns the device work routed to it.
  Requests enqueue and block on an event each; the thread drains the
  queue, coalesces, executes and wakes them. One thread a dataset makes
  concurrent answers the bits of serial execution: nothing interleaves.
- **Bounded coalescing window**: when the first request of a batch arrives
  the thread waits at most ``window`` seconds (an ``Event.wait``: no clock
  read here) for more, then drains up to ``max_batch``. ``window=0``
  dispatches every request alone (the latency floor); a large window
  coalesces every concurrent request (the throughput ceiling). Answers are
  the same bits at every window.
- **Grouping**: drained requests coalesce only within (dataset, kind):
  rank queries against one dataset merge their ks into one
  ``select_many`` call; other ops (topk, certificates) run one at a time
  on the same thread. Arrival order holds within and across groups.

Resilience:

- **Deadlines**: a request may carry a
  :class:`~mpi_k_selection_tpu_torch.utils.timing.Deadline`; the waiter
  times out with :class:`DeadlineExceededError` (HTTP 504), and the
  dispatch thread drops expired queries before running their group.
- **Admission control**: ``max_depth`` bounds the queue; arrivals past it
  are shed with :class:`ServerOverloadedError` (HTTP 503 with
  ``Retry-After``).
- **Supervision**: a crash of the loop itself (not a group's execution
  error, which is isolated) fails only the in-flight batch with
  :class:`DispatchCrashedError`, counts a restart and resumes the loop.
  The ``serve.dispatch`` fault site (faults/inject.py) fires there.
- **Graceful drain**: ``close()`` stops admissions, lets the thread finish
  what is queued, joins it, and fails only stragglers that raced it.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading

from mpi_k_selection_tpu_torch.faults.inject import maybe_fault as _maybe_fault
from mpi_k_selection_tpu_torch.serve.errors import (
    DeadlineExceededError,
    DispatchCrashedError,
    ServerClosedError,
    ServerOverloadedError,
)

#: The name prefix of every serving-layer thread (dispatch lanes, the HTTP
#: serve loop, HTTP request handlers), the JAX package's: no such thread
#: outlives its server.
SERVE_THREAD_PREFIX = "ksel-serve"

#: Coalescing-window ceiling (seconds) — a minute-long window is a
#: misconfiguration, not a batching strategy.
MAX_WINDOW = 60.0

#: Queue-drain ceiling per dispatch round.
DEFAULT_MAX_BATCH = 1024


@dataclasses.dataclass
class PendingQuery:
    """One enqueued request. ``kind`` is ``"rank"`` (ks carries the
    1-indexed ranks) or an op name executed singly. ``ds`` is the
    RESOLVED ResidentDataset the request validated against — carried by
    object so a concurrent drop+re-add of the same id cannot swap the
    data (and its n) out from under an in-flight request. ``run`` is the
    server-provided executor for non-rank ops. The dispatch thread fills
    exactly one of ``result``/``error`` and sets ``done``."""

    dataset_id: str
    kind: str
    ks: tuple = ()
    ds: object = None
    run: object = None
    #: request-correlation id: minted
    #: or honored by the server per query, carried through the coalesced
    #: group so the walk's batch event/span name every rider
    trace_id: str | None = None
    #: optional utils/timing.Deadline: the waiter times out against it,
    #: and the dispatch thread drops the query once it expires
    deadline: object = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None
    #: set by a timed-out waiter, so the dispatch thread's expiry drop
    #: does not count the SAME query's deadline twice in the metrics;
    #: ``_dl_lock`` makes abandon-vs-drop a real test-and-set (the two
    #: threads race on exactly this decision)
    abandoned: bool = False  # ksel: guarded-by[_dl_lock]
    _dl_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock
    )

    def wait(self):
        """Block until dispatched (bounded by ``deadline`` when set);
        re-raise the dispatch error here (on the REQUEST thread), raise
        the typed :class:`DeadlineExceededError` on timeout, or return
        the result."""
        if self.deadline is None:
            self.done.wait()
        elif not self.done.wait(timeout=self.deadline.remaining()):
            # the dispatch thread may still execute this query (its
            # result is discarded); its own expiry check drops it when
            # the group has not started yet. Decide atomically who
            # accounts the expiry: if the dispatch thread completed/
            # dropped the query between our timeout and here, fall
            # through to ITS outcome (one count, on its side)
            with self._dl_lock:
                if not self.done.is_set():
                    self.abandoned = True
                    raise DeadlineExceededError(
                        "query deadline expired before dispatch completed"
                    )
        if self.error is not None:
            raise self.error
        return self.result


def validate_window(window) -> float:
    w = float(window)
    if not 0.0 <= w <= MAX_WINDOW:
        raise ValueError(f"window={w} out of range [0, {MAX_WINDOW}] seconds")
    return w


class QueryBatcher:
    """The dispatch thread + queue. ``execute_ranks(items)``
    (server-provided) runs one coalesced rank group — all items share
    one resolved dataset object — and must fill every item's
    ``result``; ``observe`` hooks (queue depth at submit, batch width
    at dispatch, shed/expired/restart counts) are optional metrics
    callbacks. ``max_depth`` bounds the queue (None = unbounded, the
    historical behavior); arrivals past it are shed with
    :class:`ServerOverloadedError` carrying ``retry_after``."""

    _ids = itertools.count()

    def __init__(
        self,
        execute_ranks,
        *,
        window: float = 0.0,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_depth: int | None = None,
        retry_after: float = 1.0,
        observe_depth=None,
        observe_width=None,
        observe_shed=None,
        observe_expired=None,
        observe_restart=None,
        name: str | None = None,
    ):
        self._execute_ranks = execute_ranks
        self.window = validate_window(window)
        self.max_batch = max(1, int(max_batch))
        self.max_depth = None if max_depth is None else max(1, int(max_depth))
        self.retry_after = float(retry_after)
        self._observe_depth = observe_depth
        self._observe_width = observe_width
        self._observe_shed = observe_shed
        self._observe_expired = observe_expired
        self._observe_restart = observe_restart
        #: dispatch-loop supervisor restarts (serve.dispatch_restarts)
        self.restarts = 0
        #: queries admitted by submit() (per-lane occupancy figure)
        self.submitted = 0  # ksel: guarded-by[_submit_lock]
        self._inflight: list = []  # the batch being dispatched right now
        self._q: queue.Queue = queue.Queue()
        # serializes submit's check+put against close's final drain, so a
        # submit racing close() either raises or its item is seen by the
        # drain — a queued request can never be left waiting forever
        self._submit_lock = threading.Lock()
        self._stop = threading.Event()
        # a lane owner (serve/lanes.py) passes its lane name; every name
        # carries the prefix either way
        if name is None:
            name = f"{SERVE_THREAD_PREFIX}-dispatch-{next(self._ids)}"
        elif not name.startswith(SERVE_THREAD_PREFIX):
            raise ValueError(
                f"dispatch thread name {name!r} must carry the "
                f"{SERVE_THREAD_PREFIX!r} prefix"
            )
        self._thread = threading.Thread(
            target=self._run,
            name=name,
            daemon=True,
        )
        self._thread.start()

    # -- request side ------------------------------------------------------

    def submit(self, item: PendingQuery) -> PendingQuery:
        with self._submit_lock:
            if self._stop.is_set():
                raise ServerClosedError("server is closed; query rejected")
            depth = self._q.qsize()
            if self.max_depth is not None and depth >= self.max_depth:
                # shed instead of queueing unboundedly: under sustained
                # overload a bounded queue keeps admitted-query latency
                # bounded; the client backs off and retries
                if self._observe_shed is not None:
                    self._observe_shed()
                raise ServerOverloadedError(
                    f"dispatch queue at its depth bound ({self.max_depth}); "
                    "query shed — retry after backoff",
                    retry_after=self.retry_after,
                )
            if self._observe_depth is not None:
                self._observe_depth(depth)
            self.submitted += 1
            self._q.put(item)
        return item

    # -- dispatch thread ---------------------------------------------------

    def _run(self) -> None:
        """Supervisor shell around the serve loop: a crash in the loop
        machinery fails ONLY the batch in flight (each unanswered item
        gets a typed :class:`DispatchCrashedError`), counts a restart,
        and resumes — the thread itself never dies of an exception, so
        queued and future queries keep being served."""
        while True:
            try:
                self._serve_loop()
                return
            except BaseException as e:
                inflight, self._inflight = self._inflight, []
                for item in inflight:
                    if not item.done.is_set():
                        item.error = DispatchCrashedError(
                            f"dispatch loop crashed while this query was in "
                            f"flight ({type(e).__name__}: {e}); the loop was "
                            "restarted"
                        )
                        item.done.set()
                self.restarts += 1
                if self._observe_restart is not None:
                    self._observe_restart(e)
                if self._stop.is_set():
                    return

    def _serve_loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            if self.window > 0.0:
                # bounded coalescing: wait once for concurrent arrivals
                # (Event.wait honors close() immediately), then drain
                self._stop.wait(self.window)
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._q.get_nowait())
                    except queue.Empty:
                        break
            # the supervisor fails exactly this list on a loop crash
            self._inflight = batch
            # chaos hook: the i-th dispatch round — OUTSIDE the per-group
            # isolation below, so an injected raise exercises the
            # supervisor-restart path (faults/inject.py)
            _maybe_fault("serve.dispatch")
            self._dispatch(batch)
            self._inflight = []
            if self._stop.is_set() and self._q.empty():
                return

    def _drop_expired(self, items) -> list:
        """Fail every already-expired query with the typed error and
        return the live remainder. Expired queries never execute: their
        waiters already gave up, and running their walk would only delay
        the live queries behind them."""
        live = []
        for item in items:
            if item.deadline is not None and item.deadline.expired:
                # decide atomically against the waiter's own timeout: a
                # waiter that already abandoned counted this query's
                # deadline itself — observe only the drops it didn't
                with item._dl_lock:
                    abandoned = item.abandoned
                    item.error = DeadlineExceededError(
                        "query deadline expired before dispatch; dropped unrun"
                    )
                    item.done.set()
                if self._observe_expired is not None and not abandoned:
                    self._observe_expired()
                continue
            live.append(item)
        return live

    def _dispatch(self, batch) -> None:
        """Group a drained batch by (dataset, kind) preserving arrival
        order, execute each group, and wake every request exactly once.
        Expired queries are dropped without execution — re-checked per
        GROUP, not only at batch start, so a deadline that expires while
        an earlier group's slow walk runs still fails fast."""
        groups: dict = {}
        order = []
        for item in self._drop_expired(batch):
            # identity includes the dataset OBJECT: two requests that
            # resolved the same id across a drop+re-add must not share
            # one walk over whichever dataset happens to be current
            key = (item.dataset_id, item.kind, id(item.ds))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(item)
        for key in order:
            kind = key[1]
            # an earlier group's slow walk may have outlived this
            # group's deadlines: re-check before spending device time
            items = self._drop_expired(groups[key])
            if not items:
                continue
            try:
                if kind == "rank":
                    if self._observe_width is not None:
                        self._observe_width(sum(len(i.ks) for i in items))
                    self._execute_ranks(items)
                else:
                    for item in items:
                        item.result = item.run()
            except BaseException as e:
                for item in items:
                    if item.result is None:
                        item.error = e
            finally:
                for item in items:
                    item.done.set()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop accepting queries, let the dispatch thread finish what is
        queued, join it, and fail anything still pending (a request that
        raced the close) with :class:`ServerClosedError` so no client
        thread blocks forever. Idempotent."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        # drain under the submit lock: any submit that won the race into
        # the queue is failed here; any submit after sees the stop flag
        with self._submit_lock:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                item.error = ServerClosedError("server closed before dispatch")
                item.done.set()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    @property
    def depth(self) -> int:
        """Current dispatch-queue depth (approximate — the queue moves)."""
        return self._q.qsize()
