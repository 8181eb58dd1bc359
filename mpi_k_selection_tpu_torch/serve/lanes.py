"""Per-device dispatch lanes: one supervised batcher a device
(counterpart of ``mpi_k_selection_tpu/serve/lanes.py``).

Answers must be the bits of serial execution per dataset (one dataset's
coalesced walks must not interleave), but two datasets on different
devices share no state, so one thread for both would only make one
device's slow walk block the other's fast one. This module keeps the
per-dataset guarantee and drops the global one:

- **Lane key**: every resolved dataset maps to a fixed key
  (:func:`lane_key_for`): the device recorded at registration for a
  device dataset (``"cuda:0"``, ``"cpu:1"``), ``"stream"`` for an
  out-of-core one (streamed descents manage their own staging devices and
  share the staging pool, so they serialize against each other). The key
  never changes, so all of a dataset's queries land in one lane. The JAX
  package keys by the array's committed devices; the port never reads the
  device back from the tensor, since a ``cpu:1`` tensor reports ``cpu``.
- **Lanes are whole batchers**: each lane is a
  :class:`~mpi_k_selection_tpu_torch.serve.batcher.QueryBatcher` with its
  window, deadline drops, admission control (``max_depth`` bounds each
  lane's queue) and supervised restarts. A crash in one lane's loop
  restarts only that lane.
- **Lane count**: ``lanes="auto"`` (default) opens one lane per distinct
  key, at its first query. ``lanes=N`` folds keys onto N lanes by CRC32
  (a stable hash: ``hash()`` is seeded per process); ``lanes=1`` is the
  single batcher.

Lane threads are named ``ksel-serve-lane-<key>-dispatch``; ``close()``
closes every lane and joins every dispatch thread.
"""

from __future__ import annotations

import threading
import zlib

from mpi_k_selection_tpu_torch.serve.batcher import DEFAULT_MAX_BATCH, SERVE_THREAD_PREFIX, QueryBatcher
from mpi_k_selection_tpu_torch.serve.errors import ServerClosedError


def lane_key_for(ds) -> str:
    """The dispatch-lane key of one resolved dataset, a pure function of
    what was fixed at registration, so every query against it lands in
    the same lane: the recorded device of a device dataset, ``"stream"``
    for a stream."""
    if ds.residency == "device":
        return ds.device or "device"
    return ds.residency


def validate_lanes(lanes):
    """``"auto"`` or an int >= 1."""
    if lanes == "auto":
        return lanes
    n = int(lanes)
    if n < 1:
        raise ValueError(f"lanes={lanes!r} must be 'auto' or an int >= 1")
    return n


class LaneDispatcher:
    """The server's dispatch surface: routes each
    :class:`~mpi_k_selection_tpu_torch.serve.batcher.PendingQuery` to its
    dataset's lane, creating lanes lazily. Presents the same submit/
    restarts/closed/close surface as one ``QueryBatcher``; ``observe_depth`` and
    ``observe_restart`` gain a trailing ``lane`` name argument so the
    metrics can carry the per-lane label."""

    def __init__(
        self,
        execute_ranks,
        *,
        lanes="auto",
        window: float = 0.0,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_depth: int | None = None,
        retry_after: float = 1.0,
        observe_depth=None,
        observe_width=None,
        observe_shed=None,
        observe_expired=None,
        observe_restart=None,
    ):
        self.lanes = validate_lanes(lanes)
        self._execute_ranks = execute_ranks
        self._window = window
        self._max_batch = max_batch
        self._max_depth = max_depth
        self._retry_after = retry_after
        self._observe_depth = observe_depth
        self._observe_width = observe_width
        self._observe_shed = observe_shed
        self._observe_expired = observe_expired
        self._observe_restart = observe_restart
        self._lock = threading.Lock()
        self._lanes: dict[str, QueryBatcher] = {}  # ksel: guarded-by[_lock]
        self._stop = False  # ksel: guarded-by[_lock]

    # -- routing -----------------------------------------------------------

    def _lane_name(self, ds) -> str:
        key = lane_key_for(ds)
        if self.lanes == "auto":
            return key
        if self.lanes == 1:
            # the single lane: one thread, one queue, every dataset
            # serialized through it
            return "lane0"
        return f"lane{zlib.crc32(key.encode()) % self.lanes}"

    def _lane_for(self, ds) -> QueryBatcher:
        name = self._lane_name(ds)
        with self._lock:
            if self._stop:
                raise ServerClosedError("server is closed; query rejected")
            lane = self._lanes.get(name)
            if lane is None:
                lane = QueryBatcher(
                    self._execute_ranks,
                    window=self._window,
                    max_batch=self._max_batch,
                    max_depth=self._max_depth,
                    retry_after=self._retry_after,
                    observe_depth=self._wrap_depth(name),
                    observe_width=self._observe_width,
                    observe_shed=self._observe_shed,
                    observe_expired=self._observe_expired,
                    observe_restart=self._wrap_restart(name),
                    name=f"{SERVE_THREAD_PREFIX}-lane-{name}-dispatch",
                )
                self._lanes[name] = lane
        return lane

    def _wrap_depth(self, name: str):
        if self._observe_depth is None:
            return None
        return lambda depth: self._observe_depth(depth, name)

    def _wrap_restart(self, name: str):
        if self._observe_restart is None:
            return None
        return lambda exc: self._observe_restart(exc, name)

    # -- the QueryBatcher surface ------------------------------------------

    def submit(self, item):
        """Route to the item's dataset lane (created on first use) and
        enqueue — admission control and closed checks are the lane's."""
        return self._lane_for(item.ds).submit(item)

    @property
    def restarts(self) -> int:
        """Supervisor restarts summed over every lane (the
        ``serve.dispatch_restarts`` figure)."""
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(lane.restarts for lane in lanes)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._stop

    @property
    def depth(self) -> int:
        """Queued queries summed over every lane (approximate)."""
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(lane.depth for lane in lanes)

    @property
    def lane_count(self) -> int:
        with self._lock:
            return len(self._lanes)

    def lane_summary(self) -> dict:
        """Per-lane occupancy snapshot: ``{lane: {submitted,
        queue_depth, restarts}}``: the /debug/bundle "lanes" section."""
        with self._lock:
            lanes = dict(self._lanes)
        return {
            name: {
                "submitted": int(lane.submitted),
                "queue_depth": int(lane.depth),
                "restarts": int(lane.restarts),
            }
            for name, lane in sorted(lanes.items())
        }

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop admitting (new lanes AND new submits), then drain and
        join every lane's dispatch thread. Idempotent; a submit racing
        close either fails here-or-there with
        :class:`~mpi_k_selection_tpu_torch.serve.errors.ServerClosedError` or
        is drained by its lane's own close."""
        with self._lock:
            self._stop = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.close()
