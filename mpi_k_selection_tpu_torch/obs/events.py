"""Typed telemetry events of the streamed descent and pluggable sinks
(counterpart of ``mpi_k_selection_tpu/obs/events.py``: the same event
kinds and fields, so an event stream of the port compares entry for entry
with the JAX package's).

- every radix pass of the streamed descent (replay, spill and collect)
  emits one :class:`StreamPassEvent`; every consumed chunk a
  :class:`ChunkEvent` with its round-robin device slot; every committed
  spill generation a :class:`SpillGenerationEvent`; the resident and
  distributed entry points one :class:`ResidentSelectEvent` /
  :class:`DistributedSelectEvent` a call.
- events are frozen dataclasses of host integers the descent has computed
  anyway, so emitting one never changes an answer bit.
- sinks are off by default: without an
  :class:`~mpi_k_selection_tpu_torch.obs.Observability` the descent skips
  every emission behind one ``obs is None`` check.

:class:`FaultEvent` is emitted by the fault harness, and
:class:`ServeQueryEvent` / :class:`ServeBatchEvent` by the query server,
once those are ported (ROADMAP Queue 1 items 4 and 6).
:func:`check_stream_invariants` is the event stream's structural contract
(monotone pass indices, non-increasing survivor populations, bytes equal
to a spill store's ``pass_log``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar


@dataclasses.dataclass(frozen=True)
class ObsEvent:
    """Base telemetry event. ``kind`` names the event type; ``as_dict``
    is the JSON-ready form every sink/exporter shares."""

    kind: ClassVar[str] = "event"

    def as_dict(self) -> dict:
        d = {"event": self.kind}
        d.update(dataclasses.asdict(self))
        return d


@dataclasses.dataclass(frozen=True)
class StreamPassEvent(ObsEvent):
    """One streamed radix pass of the exact descent (pass 0, every later
    prefix-filtered pass, and the final collect as ``pass_index
    "collect"``).

    ``survivors`` is the per-rank population tuple AFTER this pass's
    bucket walk, aligned with the descent's rank order and covering every
    rank (parked ranks keep their last population) — so consecutive
    events are elementwise non-increasing, the geometric-shrink contract
    :func:`check_stream_invariants` checks.
    """

    kind: ClassVar[str] = "stream.pass"

    pass_index: object  # int radix level, or "collect"
    resolved_bits: int
    prefixes: tuple  # active (being-histogrammed) prefixes this pass
    chunks: int  # chunks consumed
    keys_read: int
    bytes_read: int
    read_from: str  # "source" | "spill"
    bucket_total: int  # total population counted across prefixes
    bucket_max: int  # heaviest single bucket
    bucket_nonzero: int  # buckets holding >= 1 key
    survivors: tuple  # per-rank populations after the walk
    keys_written: int | None = None  # spill survivors written (None = no tee)
    bytes_written: int | None = None
    #: PHYSICAL bytes moved (spill.py's on-disk record payloads, packed
    #: when ``pack_spill`` engaged) vs the LOGICAL ``bytes_read`` /
    #: ``bytes_written`` above (keys x itemsize, the descent-algebra
    #: unit). Written physical <= written logical always — the packer
    #: falls back to the unpacked v1 format per record rather than ever
    #: inflating. Read physical prices what a (possibly PRUNED) replay
    #: actually touches: matching segments plus each record's directory,
    #: so it can exceed the logical column on small heavily-pruned reads
    #: while collapsing far below it on the big early ones. ``None`` on
    #: old event streams only; source-read passes report physical ==
    #: logical (the source hands keys at full width).
    disk_bytes_read: int | None = None
    disk_bytes_written: int | None = None


@dataclasses.dataclass(frozen=True)
class ChunkEvent(ObsEvent):
    """One chunk consumed by a streamed pass: size, staged bytes, and the
    round-robin device slot it landed on (``None`` = host-resident or the
    uncommitted default-device path) — the chunk->device assignment
    record."""

    kind: ClassVar[str] = "stream.chunk"

    pass_index: object
    chunk_index: int
    n: int
    nbytes: int
    device_slot: int | None
    staged: bool


@dataclasses.dataclass(frozen=True)
class SpillGenerationEvent(ObsEvent):
    """One committed spill generation (pass-0 tee or a filtered survivor
    write): its record count, key count and payload bytes. ``nbytes`` is
    the PHYSICAL on-disk payload total; ``logical_nbytes`` (keys x
    itemsize) is what those keys cost unpacked, so ``nbytes /
    logical_nbytes`` is the generation's disk compression ratio when
    ``packed`` (any record in the v2 prefix-packed format) is True —
    and the two are equal when it is False."""

    kind: ClassVar[str] = "spill.generation"

    generation: int
    records: int
    keys: int
    nbytes: int
    logical_nbytes: int | None = None
    packed: bool = False


@dataclasses.dataclass(frozen=True)
class SketchPassEvent(ObsEvent):
    """One ``RadixSketch.update_stream`` accumulation pass."""

    kind: ClassVar[str] = "sketch.pass"

    chunks: int
    keys_read: int
    bytes_read: int
    staged_chunks: int


@dataclasses.dataclass(frozen=True)
class CertificateEvent(ObsEvent):
    """One streamed rank-certificate pass: the (less, leq) counts."""

    kind: ClassVar[str] = "certificate.pass"

    chunks: int
    keys_read: int
    less: int
    leq: int


@dataclasses.dataclass(frozen=True)
class ResidentSelectEvent(ObsEvent):
    """One resident (in-core) selection dispatch at the api shell
    (per-pass events are the streamed descent's only)."""

    kind: ClassVar[str] = "resident.select"

    n: int
    queries: int
    algorithm: str
    dtype: str


@dataclasses.dataclass(frozen=True)
class DistributedSelectEvent(ObsEvent):
    """One distributed selection dispatch at the parallel/ entry shell."""

    kind: ClassVar[str] = "distributed.select"

    n: int
    queries: int
    n_devices: int
    radix_bits: int
    cutover_passes: int | None
    dtype: str


@dataclasses.dataclass(frozen=True)
class ServeQueryEvent(ObsEvent):
    """One client request answered by the query server (serve/server.py):
    which dataset and op, the tier requested vs the tier that answered
    (``tier_requested`` is None for non-tiered ops), how many rank
    queries the request carried, and whether auto escalated it from
    sketch to exact."""

    kind: ClassVar[str] = "serve.query"

    dataset: str
    op: str  # kselect | quantiles | topk | rank_certificate
    tier_requested: str | None
    tier_answered: str
    queries: int
    escalated: bool
    #: request-correlation id: minted
    #: per query by the server (or honored from the client's
    #: ``X-Ksel-Trace-Id``); ``None`` for embedding callers that pass none
    trace_id: str | None = None


@dataclasses.dataclass(frozen=True)
class FaultEvent(ObsEvent):
    """One fault observation: an injected fault firing, or a resilience
    policy acting on a (real or injected) failure. ``action`` is the
    lifecycle step:

    - ``"inject"``  — the harness fired a scheduled fault (site/kind/
      index/attempt name it);
    - ``"retry"``   — a RetryPolicy is retrying after a transient error;
    - ``"reread"``  — the spill recovery ladder is re-reading a
      generation after a record validation failure;
    - ``"rebuild"`` — the ladder gave up on the generation and is
      re-running the pass from its fallback (the replayable source, or a
      one-shot run's gen-0 tee);
    - ``"degrade"`` — ENOSPC downgraded ``spill="auto"`` to the replay
      of the last good generation (spilling disabled for the rest of the
      descent);
    - ``"shed"``    — the query server refused admission (queue depth
      bound);
    - ``"deadline"``— a request's deadline expired (failed fast);
    - ``"restart"`` — the batcher's dispatch loop crashed and was
      restarted (in-flight queries failed, queued ones survive).

    ``error`` is the triggering exception rendered as
    ``"TypeName: message"`` (empty for injections and sheds). Pure host
    observation, like every event here: emitting can never change an
    answer bit."""

    kind: ClassVar[str] = "fault"

    site: str
    action: str
    fault_kind: str | None = None
    index: int | None = None
    attempt: int = 0
    error: str = ""


@dataclasses.dataclass(frozen=True)
class ServeBatchEvent(ObsEvent):
    """One coalesced dispatch of the query server's batcher: how many
    client requests rode the shared-pass walk and the total rank-query
    width they coalesced into. ``trace_ids`` are the request-correlation
    ids of every query in the group,
    so one slow walk is joinable back to the client requests that rode
    it."""

    kind: ClassVar[str] = "serve.batch"

    dataset: str
    requests: int
    width: int
    trace_ids: tuple = ()


@dataclasses.dataclass(frozen=True)
class RecompileStormEvent(ObsEvent):
    """The runtime twin of KSC103/KSL010 (obs/ledger.py): one dispatch
    site's distinct-program compile count crossed the ledger's storm
    threshold — the site is serving shape/width churn at compile latency.
    Emitted on the crossing compile and every later one; ``key`` is the
    repr of the compile key that triggered it, ``compiles`` the site's
    distinct-key compile total at emission."""

    kind: ClassVar[str] = "ledger.recompile_storm"

    site: str
    key: str
    compiles: int
    threshold: int


class EventSink:
    """Sink protocol: ``emit`` receives every event. Implementations must
    be thread-safe — the pipelined descent emits from both the producer
    and the consumer thread."""

    def emit(self, event: ObsEvent) -> None:  # pragma: no cover - protocol
        raise NotImplementedError


class ListSink(EventSink):
    """Collects events in arrival order (thread-safe append). The default
    sink for tests and post-run analysis."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[ObsEvent] = []  # ksel: guarded-by[_lock]

    def emit(self, event: ObsEvent) -> None:
        with self._lock:
            self.events.append(event)

    def of_kind(self, kind: str) -> list[ObsEvent]:
        with self._lock:
            return [e for e in self.events if e.kind == kind]

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)


class CallbackSink(EventSink):
    """Adapts a plain callable into a sink (the caller owns its thread
    safety — it may be invoked from the producer thread)."""

    def __init__(self, fn):
        self._fn = fn

    def emit(self, event: ObsEvent) -> None:
        self._fn(event)


def check_stream_invariants(events, spill_pass_log=None) -> None:
    """Assert the structural contract of one descent's event stream;
    raises ``AssertionError`` naming the first violation.

    - at least one :class:`StreamPassEvent`, integer pass indices strictly
      increasing, any ``"collect"`` event last;
    - per-rank ``survivors`` tuples elementwise non-increasing pass over
      pass (the descent only ever narrows), each bounded by that pass's
      ``keys_read``;
    - ``bucket_total`` accounting: pass 0 counts the whole stream
      (``bucket_total == keys_read``); later passes count only the
      surviving active-prefix populations, so ``bucket_total`` is bounded
      by ``keys_read`` and non-increasing pass over pass;
    - the terminal collect event carries the honest per-spec accounting
      (the executor knows every spec's survivor count at drain time):
      ``survivors`` aligns with ``prefixes`` one collected population per
      spec, each >= 1 (a collect spec is a walked bucket holding the
      rank), ``bucket_total`` is their sum and ``bucket_max`` their max,
      all bounded by that pass's ``keys_read``;
    - chunk events: per-pass chunk indices 0..chunks-1 in order, sizes
      summing to ``keys_read``, staged slots well-formed;
    - physical vs logical byte accounting on the WRITE side:
      ``disk_bytes_written <= bytes_written`` on every pass that reports
      them — the prefix packer never inflates a record (it falls back to
      the unpacked v1 format per record). The read side carries no such
      bound: a PRUNED replay reads each record's segment directory, bytes
      the logical column (keys streamed x itemsize) does not see, so
      small heavily-pruned reads can price more disk than logical bytes;
    - with ``spill_pass_log`` (a ``SpillStore.pass_log``): the events'
      bytes_read/bytes_written AND disk_bytes_read/disk_bytes_written
      match the store's log entry for entry.
    """
    passes = [e for e in events if isinstance(e, StreamPassEvent)]
    assert passes, "no StreamPassEvent emitted"
    int_idx = [e.pass_index for e in passes if isinstance(e.pass_index, int)]
    assert int_idx == sorted(set(int_idx)), (
        f"pass indices not strictly increasing: {int_idx}"
    )
    for e in passes[:-1]:
        assert e.pass_index != "collect", "collect event is not last"
    prev = None
    for e in passes:
        if e.pass_index == "collect":
            assert len(e.survivors) == len(e.prefixes), (
                f"collect: {len(e.survivors)} survivor populations for "
                f"{len(e.prefixes)} specs"
            )
            assert all(s >= 1 for s in e.survivors), (
                f"collect: empty spec population in {e.survivors} — every "
                "collect spec is a walked bucket holding its rank"
            )
            assert e.bucket_total == sum(e.survivors), (
                f"collect: bucket_total {e.bucket_total} != "
                f"sum(survivors) {sum(e.survivors)}"
            )
            assert e.bucket_max == max(e.survivors, default=0), (
                f"collect: bucket_max {e.bucket_max} != max(survivors)"
            )
            assert e.bucket_total <= e.keys_read, (
                f"collect: collected {e.bucket_total} exceeds keys_read "
                f"{e.keys_read}"
            )
            continue
        assert len(e.survivors) >= 1, f"pass {e.pass_index}: no survivors tuple"
        assert all(0 <= s <= e.keys_read for s in e.survivors), (
            f"pass {e.pass_index}: survivors {e.survivors} exceed "
            f"keys_read {e.keys_read}"
        )
        assert e.bucket_max <= e.bucket_total, f"pass {e.pass_index}: bucket summary"
        assert e.bucket_total <= e.keys_read, (
            f"pass {e.pass_index}: bucket_total {e.bucket_total} exceeds "
            f"keys_read {e.keys_read}"
        )
        if e.pass_index == 0 and not e.prefixes:
            # the unfiltered length-scan pass counts EVERY key it read
            assert e.bucket_total == e.keys_read, (
                f"pass 0: bucket_total {e.bucket_total} != keys_read "
                f"{e.keys_read} on the unfiltered pass"
            )
        if prev is not None:
            assert e.bucket_total <= prev.bucket_total, (
                f"pass {e.pass_index}: counted population {e.bucket_total} "
                f"grew past the previous pass's {prev.bucket_total}"
            )
            assert len(e.survivors) == len(prev.survivors), (
                "rank count changed mid-descent"
            )
            assert all(
                s <= p for s, p in zip(e.survivors, prev.survivors)
            ), (
                f"pass {e.pass_index}: survivors {e.survivors} grew past "
                f"{prev.survivors}"
            )
        prev = e
    by_pass: dict = {}
    for c in events:
        if isinstance(c, ChunkEvent):
            by_pass.setdefault(c.pass_index, []).append(c)
    for e in passes:
        chunks = by_pass.get(e.pass_index, [])
        if not chunks:  # chunk events off, or a zero-chunk pass
            continue
        # a recovered pass (faults/policy.py: pass-level retry, spill
        # rebuild) re-ran its chunk loop, so the pass may carry chunk
        # events from ABORTED attempts before the successful one; only
        # the final attempt — the run from the LAST chunk_index == 0
        # onward — describes the pass the StreamPassEvent accounts.
        # Fault-free streams have exactly one such run, so this is the
        # historical strict check there.
        zeros = [i for i, c in enumerate(chunks) if c.chunk_index == 0]
        if zeros:
            chunks = chunks[zeros[-1]:]
        assert [c.chunk_index for c in chunks] == list(range(e.chunks)), (
            f"pass {e.pass_index}: chunk indices out of order"
        )
        assert sum(c.n for c in chunks) == e.keys_read, (
            f"pass {e.pass_index}: chunk sizes sum to "
            f"{sum(c.n for c in chunks)}, keys_read {e.keys_read}"
        )
        for c in chunks:
            assert c.device_slot is None or c.device_slot >= 0
    for e in passes:
        if e.disk_bytes_written is not None:
            assert e.bytes_written is not None, (
                f"pass {e.pass_index}: disk_bytes_written without a tee"
            )
            assert e.disk_bytes_written <= e.bytes_written, (
                f"pass {e.pass_index}: disk_bytes_written "
                f"{e.disk_bytes_written} exceeds logical bytes_written "
                f"{e.bytes_written} — the packer must never inflate a record"
            )
    if spill_pass_log is not None:
        logged = {entry["pass"]: entry for entry in spill_pass_log}
        for e in passes:
            entry = logged.get(e.pass_index)
            if entry is None:
                continue
            assert e.bytes_read == entry["bytes_read"], (
                f"pass {e.pass_index}: event bytes_read {e.bytes_read} != "
                f"pass_log {entry['bytes_read']}"
            )
            if e.bytes_written is not None:
                assert e.bytes_written == entry.get("bytes_written"), (
                    f"pass {e.pass_index}: event bytes_written "
                    f"{e.bytes_written} != pass_log "
                    f"{entry.get('bytes_written')}"
                )
            if e.disk_bytes_read is not None and "disk_bytes_read" in entry:
                assert e.disk_bytes_read == entry["disk_bytes_read"], (
                    f"pass {e.pass_index}: event disk_bytes_read "
                    f"{e.disk_bytes_read} != pass_log "
                    f"{entry['disk_bytes_read']}"
                )
            if e.disk_bytes_written is not None:
                assert e.disk_bytes_written == entry.get(
                    "disk_bytes_written"
                ), (
                    f"pass {e.pass_index}: event disk_bytes_written "
                    f"{e.disk_bytes_written} != pass_log "
                    f"{entry.get('disk_bytes_written')}"
                )
