"""Runtime ledger: process-wide launch and device-memory accounting
(counterpart of ``mpi_k_selection_tpu/obs/ledger.py``, with its names).

- **Program ledger**: dispatch sites report through
  :func:`ledger_dispatch` with a key of what their launch specializes on.
  The first dispatch of a key at a site counts as a compile and its wall
  is clocked through a :class:`~mpi_k_selection_tpu_torch.utils.
  profiling.PhaseTimer`; repeats are cache hits. PyTorch compiles nothing
  per shape, so in the port a "compile" is the first launch of a kind:
  its wall includes the lazy ``nvcc`` build of its source when it is the
  process's first (ops/cuda/build.py). The resident ``api.select`` site
  keeps the JAX package's key; the streamed sites are booked by the sweep
  kernel's launch kind (``ingest.histogram``, ``ingest.fused`` for a
  histogram with the spill tee, ``ingest.collect``, ``ingest.certificate``,
  ``ingest.sketch``), keyed by the key word's dtype, where the JAX package
  books one program per part and staging bucket.
- **Recompile-storm detector**: a site whose distinct-key compile count
  passes ``storm_threshold`` fires a
  :class:`~mpi_k_selection_tpu_torch.obs.events.RecompileStormEvent`.
- **Device-memory accounting**: ``ledger.device_bytes{pool,device}``:
  ``staging`` (the live staged chunks, per card), ``staging_pool`` (the
  pinned free lists on the host) and ``spill`` (generations on disk,
  device ``"disk"``), each with its peak.

Everything is host ints under one lock: reporting never changes an
answer bit. The module-level :data:`LEDGER` is process-wide like
``pipeline.STAGING_POOL``; per-run readings are snapshot deltas
(:meth:`ProgramLedger.snapshot`, :func:`snapshot_delta`), and
:func:`collect_ledger` is the one writer of the ``ledger.*`` metrics.
"""

from __future__ import annotations

import collections
import contextlib
import threading

from mpi_k_selection_tpu_torch.obs.events import RecompileStormEvent

#: Distinct-key compiles at ONE site beyond which further compiles are
#: counted as recompiles and fire RecompileStormEvents. A healthy site
#: compiles a handful of programs (one per staging bucket / dtype /
#: spec width) and then hits; a site crossing this is serving shape
#: churn at compile latency — the KSC103 hazard observed live.
DEFAULT_STORM_THRESHOLD = 8

#: Bounded ring of the most recent storm events the ledger itself keeps
#: (obs-independent — the flight recorder's bundle reads it).
STORM_RING = 64

#: Per-site bound on the key mirrors (FIFO-evicted past it). The ledger
#: is process-lifetime, so unbounded retention of every distinct compile
#: key — serve keys embed dataset ids, eager certificate keys every
#: ragged chunk length — would grow monotonically until the process
#: dies. Past the bound an evicted key that recurs is re-counted as a
#: compile (and re-inflates the distinct counters): a site with 4096
#: live program identities is deep in the churn pathology the storm
#: detector fired on ~4088 keys earlier, so the books degrade to
#: approximations only where they already read "storm".
MAX_TRACKED_KEYS = 4096


def _new_site() -> dict:
    return {
        "keys": {},  # key -> dispatch count (bounded mirror, FIFO-evicted)
        "storm_keys": {},  # shape-churn identities (bounded like keys)
        "distinct": 0,  # first-seen keys, monotone (survives eviction)
        "storm_distinct": 0,  # first-seen churn identities, monotone
        "compiles": 0,
        "hits": 0,
        "recompiles": 0,
    }


def _bounded_insert(book: dict, key, count: int = 1) -> bool:
    """Record ``key`` in a bounded FIFO mirror (dict insertion order):
    returns True when it is first-seen; evicts the oldest entry past
    :data:`MAX_TRACKED_KEYS`."""
    if key in book:
        book[key] += count
        return False
    book[key] = count
    if len(book) > MAX_TRACKED_KEYS:
        del book[next(iter(book))]
    return True


class ProgramLedger:
    """Process-wide compile & device-memory book. Thread-safe; every
    mutation is host-int bookkeeping under one lock, cheap enough to sit
    on per-chunk dispatch paths."""

    def __init__(self, *, storm_threshold: int = DEFAULT_STORM_THRESHOLD):
        self._lock = threading.Lock()
        self._sites: dict[str, dict] = {}  # ksel: guarded-by[_lock]
        self._bytes: dict = {}  # ksel: guarded-by[_lock] ((pool, device) -> bytes)
        self._bytes_peak: dict = {}  # ksel: guarded-by[_lock]
        #: compile walls accumulate here as ``ledger.compile.<site>``
        #: phases: the one sanctioned clock route (KSL004). Created
        #: lazily: a process that dispatches nothing never makes one.
        self._timer = None  # ksel: guarded-by[_lock] (slot; the timer locks itself)
        self.storm_threshold = int(storm_threshold)
        self.storm_events: collections.deque = collections.deque(
            maxlen=STORM_RING
        )  # deque: self-synchronizing appends; snapshot() copies it whole

    def _get_timer(self):
        with self._lock:
            if self._timer is None:
                from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

                self._timer = PhaseTimer()
            return self._timer

    # -- program accounting ------------------------------------------------

    def _note_compile_locked(self, st: dict, site: str, key, storm_key=None):
        """Count one compile at ``site`` (caller holds the lock) and
        return the storm event to publish, or None below threshold. The
        storm trigger is the DISTINCT-key compile count — the documented
        shape-churn signal — so a :meth:`compile_span` site rebuilding
        the SAME program key (a legitimately invalidated cache, e.g. a
        dataset dropped and re-added) never reads as churn; keyless
        compiles fall back to the total as the conservative bound.
        ``storm_key`` (default: the key itself) is the identity counted
        toward the threshold — sites whose keys carry a bounded static
        dimension that legitimately multiplies compiles in ONE healthy
        run (the descent's per-level ``shift``) pass the key with that
        dimension stripped, so levels x buckets can't read as churn."""
        st["compiles"] += 1
        if key is not None:
            if _bounded_insert(st["keys"], key):
                st["distinct"] += 1
            if _bounded_insert(
                st["storm_keys"], key if storm_key is None else storm_key
            ):
                st["storm_distinct"] += 1
        distinct = st["storm_distinct"] if key is not None else st["compiles"]
        if distinct <= self.storm_threshold:
            return None
        st["recompiles"] += 1
        return RecompileStormEvent(
            site=site,
            key=repr(key),
            compiles=distinct,
            threshold=self.storm_threshold,
        )

    def _publish_storm(self, storm, obs) -> None:
        if storm is None:
            return
        self.storm_events.append(storm)
        if obs is not None:
            obs.emit(storm)

    def _note(self, site: str, key, obs, storm_key=None):
        """Record one dispatch; returns True when it is a first-key
        compile (the caller's block should be clocked)."""
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                st = self._sites[site] = _new_site()
            cnt = st["keys"].get(key)
            if cnt is not None:
                st["keys"][key] = cnt + 1
                st["hits"] += 1
                return False
            # _note_compile_locked records the key's first dispatch
            storm = self._note_compile_locked(st, site, key, storm_key)
        self._publish_storm(storm, obs)
        return True

    @contextlib.contextmanager
    def dispatch(self, site: str, key, obs=None, storm_key=None):
        """Context manager around ONE program dispatch at ``site`` whose
        compile identity is ``key`` (a hashable of the shapes / widths /
        dtypes the program specializes on). First key per site = a
        compile: the wrapped block's wall — trace + compile + first run,
        the latency a client actually pays — accumulates as the site's
        compile seconds. Repeat keys are cache hits (unclocked). Yields
        ``True`` on the compile dispatch. With ``obs``, a storm past the
        threshold emits the typed
        :class:`~mpi_k_selection_tpu_torch.obs.events.RecompileStormEvent` to
        its sink (the ``ledger.recompiles{site}`` counter rides
        :func:`collect_ledger`'s snapshot, never a dispatch-time inc).
        ``storm_key`` strips a static dimension from the churn identity
        (see :meth:`_note_compile_locked`)."""
        if not self._note(site, key, obs, storm_key):
            yield False
            return
        with self._get_timer().phase(f"ledger.compile.{site}"):
            yield True

    def note_hit(self, site: str, key=None) -> None:
        """Count one cache hit at ``site`` WITHOUT inferring novelty from
        the key — for caches that already know (serve ProgramCache)."""
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                st = self._sites[site] = _new_site()
            st["hits"] += 1
            if key is not None and _bounded_insert(st["keys"], key):
                st["distinct"] += 1

    @contextlib.contextmanager
    def compile_span(self, site: str, key, obs=None):
        """Count (and clock) one KNOWN compile at ``site`` — the twin of
        :meth:`note_hit` for caches that decide hit/miss themselves. The
        storm discipline is identical to :meth:`dispatch`."""
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                st = self._sites[site] = _new_site()
            storm = self._note_compile_locked(st, site, key)
        self._publish_storm(storm, obs)
        with self._get_timer().phase(f"ledger.compile.{site}"):
            yield True

    # -- device-memory accounting ------------------------------------------

    @staticmethod
    def _bytes_key(pool, device) -> tuple:
        return (str(pool), "default" if device is None else str(device))

    def adjust_bytes(self, pool: str, device, delta: int) -> None:
        """Add ``delta`` (may be negative) to the live byte gauge of one
        ``(pool, device)`` slot, tracking its peak. Pools in use:
        ``staging`` (live StagedKeys tensors, per card), ``staging_pool``
        (the pinned free lists on the host), ``spill`` (generations on
        disk, device ``"disk"``)."""
        key = self._bytes_key(pool, device)
        with self._lock:
            v = self._bytes.get(key, 0) + int(delta)
            self._bytes[key] = v
            if v > self._bytes_peak.get(key, 0):
                self._bytes_peak[key] = v

    def set_bytes(self, pool: str, device, value: int) -> None:
        """Absolute form of :meth:`adjust_bytes` for surfaces that track
        their own total (StagingPool.resident_bytes)."""
        key = self._bytes_key(pool, device)
        with self._lock:
            v = int(value)
            self._bytes[key] = v
            if v > self._bytes_peak.get(key, 0):
                self._bytes_peak[key] = v

    def device_bytes(self, pool: str | None = None) -> dict:
        """``{(pool, device): bytes}`` live snapshot (one pool's slots
        when ``pool`` names one)."""
        with self._lock:
            return {
                k: v
                for k, v in self._bytes.items()
                if pool is None or k[0] == pool
            }

    # -- snapshots ---------------------------------------------------------

    def compile_seconds(self) -> dict:
        """``{site: seconds}`` accumulated first-dispatch walls. Never
        creates the timer: a snapshot stays pure bookkeeping."""
        with self._lock:
            timer = self._timer
        if timer is None:
            return {}
        prefix = "ledger.compile."
        return {
            name[len(prefix):]: d["seconds"]
            for name, d in timer.as_dict().items()
            if name.startswith(prefix)
        }

    def snapshot(self) -> dict:
        """Plain-dict state: per-site compile/hit/recompile counts and
        distinct program keys, compile walls, live and peak bytes per
        (pool, device), and the recent storm tail — the JSON-ready form
        bench records delta and the flight recorder bundles."""
        with self._lock:
            sites = {
                site: {
                    "compiles": st["compiles"],
                    "hits": st["hits"],
                    "recompiles": st["recompiles"],
                    "distinct_keys": st["distinct"],
                }
                for site, st in self._sites.items()
            }
            dev_bytes = {
                f"{pool}/{dev}": v for (pool, dev), v in self._bytes.items()
            }
            dev_peak = {
                f"{pool}/{dev}": v
                for (pool, dev), v in self._bytes_peak.items()
            }
            storms = list(self.storm_events)
        for site, s in self.compile_seconds().items():
            sites.setdefault(
                site,
                {"compiles": 0, "hits": 0, "recompiles": 0, "distinct_keys": 0},
            )["compile_seconds"] = round(s, 6)
        return {
            "storm_threshold": self.storm_threshold,
            "sites": sites,
            "device_bytes": dev_bytes,
            "device_bytes_peak": dev_peak,
            "storms": [e.as_dict() for e in storms],
        }

    def reset(self) -> None:
        """Drop every count — tests owning a private ledger instance;
        production readings snapshot-delta instead (the process ledger
        is shared exactly like ``pipeline.STAGING_POOL``)."""
        with self._lock:
            self._sites.clear()
            self._bytes.clear()
            self._bytes_peak.clear()
            self._timer = None
        self.storm_events.clear()


#: The process-wide ledger every dispatch surface reports into (the
#: STAGING_POOL discipline: module-level, shared across runs; per-run
#: readings are snapshot deltas).
LEDGER = ProgramLedger()


def ledger_dispatch(
    site: str, key, obs=None, ledger: ProgramLedger | None = None,
    storm_key=None,
):
    """THE wiring helper dispatch sites use::

        with ledger_dispatch("ingest.histogram", (bucket, dt, nspecs), obs):
            handle = dispatch_chunk_histograms(...)

    Reports into :data:`LEDGER` unless a private ``ledger`` is passed
    (unit tests). ``storm_key`` strips a static dimension from the storm
    detector's churn identity. Pure host bookkeeping: never touches the
    dispatched values."""
    return (LEDGER if ledger is None else ledger).dispatch(
        site, key, obs=obs, storm_key=storm_key
    )


def snapshot_delta(before: dict, after: dict) -> dict:
    """Per-site compile/hit/recompile deltas between two
    :meth:`ProgramLedger.snapshot` readings — the per-run form bench
    records embed (the ledger itself is process-lifetime).
    ``device_bytes_peak`` keeps only the slots whose peak GREW inside
    the window: an unchanged peak was attained by an earlier run and
    would misattribute that run's high-water mark to this one."""
    sites = {}
    for site, st in after["sites"].items():
        b = before["sites"].get(site, {})
        d = {
            k: st.get(k, 0) - b.get(k, 0)
            for k in ("compiles", "hits", "recompiles", "distinct_keys")
        }
        d["compile_seconds"] = round(
            st.get("compile_seconds", 0.0) - b.get("compile_seconds", 0.0), 6
        )
        if any(d.values()):
            sites[site] = d
    return {
        "sites": sites,
        "compiles": sum(d["compiles"] for d in sites.values()),
        "recompiles": sum(d["recompiles"] for d in sites.values()),
        "compile_seconds": round(
            sum(d["compile_seconds"] for d in sites.values()), 6
        ),
        "device_bytes_peak": {
            slot: v
            for slot, v in after["device_bytes_peak"].items()
            if v > before["device_bytes_peak"].get(slot, 0)
        },
    }


def collect_ledger(registry, ledger: ProgramLedger | None = None):
    """Snapshot the ledger into ``registry`` — the ONE mapping from
    ledger state to exported metric names, idempotent like
    ``collect_runtime`` (Counter.set overwrites; no dispatch site ever
    writes these names directly, so there is a single writer):

    - ``ledger.compiles{site=}`` / ``ledger.cache_hits{site=}`` /
      ``ledger.recompiles{site=}`` (Counter) and
      ``ledger.compile_seconds{site=}`` (Gauge);
    - ``ledger.device_bytes{pool=,device=}`` /
      ``ledger.device_bytes_peak{pool=,device=}`` (Gauge).

    Values are the PROCESS ledger's (STAGING_POOL discipline) — per-run
    readings subtract two snapshots (:func:`snapshot_delta`). Returns
    ``registry``."""
    led = LEDGER if ledger is None else ledger
    snap = led.snapshot()
    for site, st in snap["sites"].items():
        registry.counter("ledger.compiles", labels={"site": site}).set(  # ksel: noqa[KSL013] -- ledger sites are a closed, code-defined set (the wired dispatch surfaces), not per-request data
            st["compiles"]
        )
        registry.counter("ledger.cache_hits", labels={"site": site}).set(  # ksel: noqa[KSL013] -- same closed site set
            st["hits"]
        )
        registry.counter("ledger.recompiles", labels={"site": site}).set(  # ksel: noqa[KSL013] -- same closed site set
            st["recompiles"]
        )
        registry.gauge("ledger.compile_seconds", labels={"site": site}).set(  # ksel: noqa[KSL013] -- same closed site set
            st.get("compile_seconds", 0.0)
        )
    for (pool, dev), v in led.device_bytes().items():
        registry.gauge("ledger.device_bytes", labels={"pool": pool, "device": dev}).set(  # ksel: noqa[KSL013] -- pools are a closed code-defined set and devices are bounded by the host's chip count
            v
        )
        registry.gauge("ledger.device_bytes_peak", labels={"pool": pool, "device": dev}).set(  # ksel: noqa[KSL013] -- same bounded (pool, device) set
            snap["device_bytes_peak"].get(f"{pool}/{dev}", v)
        )
    return registry
