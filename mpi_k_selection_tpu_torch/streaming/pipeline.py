"""Staging chunks onto the card, and the pipelined producer
(counterpart of ``mpi_k_selection_tpu/streaming/pipeline.py``).

A streamed pass reads every chunk once. :func:`stage_chunk` puts one
chunk's own bytes on the device as a :class:`StagedKeys` bucket: a host
chunk is copied into a pinned buffer (from :data:`STAGING_POOL`, reused
across chunks and passes) and crosses to the card with a non-blocking copy
on a side stream, and the compute stream waits on that copy; a chunk
already on the device is used in place. The sweep kernel keys the raw
words as it reads them (sub-32-bit dtypes are widened to 32-bit keys on
the device first, as the resident path widens them). Each chunk is staged
at its own length (no padding: PyTorch compiles nothing per shape), so
``pad`` is 0 here; the kernel and the consumers still honour ``n_valid``
and pads.

:class:`ChunkPipeline` runs the source, the chunk checks and the staging of
chunk *i+1* on one producer thread while the descent consumes chunk *i*.
At most ``pipeline_depth + 1`` staged chunks exist at once (those queued,
plus the one the consumer holds): the producer waits for a release before
it stages another. Each staged host chunk holds one pinned buffer, so at
most ``pipeline_depth + 1`` times the largest chunk's bytes of pinned
memory are in use at once; the pool keeps released buffers on top of
that, within its limits. Depth 0 is the synchronous path, with no thread.
A producer error is re-raised in the consumer, and closing the pipeline
(on every exit of a pass) stops and joins the thread.

``devices`` (:func:`resolve_stream_devices`) spreads the pipelined passes
over cards: the producer stages chunk *j* onto ``devices[j % p]`` through a
:class:`HostStager` of that card (each with its own copy stream), and the
consumer keeps one bundle a slot in flight (streaming/executor.py), so each
card reads its own chunks while the host folds the results in chunk order.
A replayed spill record goes back to the slot it was written from. The
slot of each chunk is recorded at staging (``StagedKeys.device_slot``):
telemetry and spill records name it, never a tensor's device.

``ingest_workers`` (:func:`resolve_ingest_workers`) picks the host data
plane of a pipelined pass. At 1 (the default) the one producer above does
everything. Above 1 the work of a chunk is split three ways, as the JAX
package splits it: ONE ``ksel-pipeline-*`` puller pulls and checks the
chunks in source order (a one-shot source is read once, a drifting dtype
raises at its chunk) and fixes each chunk's slot, ``tee_slot`` and
``"stage"`` fault index in pull order; ``W`` ``ksel-ingest-*`` workers
stage the chunks (each on its own copy stream a card) and run the v1
tee's host encode and checksum (``SpillWriter.prepare``); a reorder
sequencer hands the staged chunks to the consumer strictly in chunk order
and writes each tee record (``append_prepared``) in that same turn, so
records, chunk indices and ``spill.write`` fault keys are those of one
producer. A worker's error reaches the consumer at its chunk, after every
earlier one, and the chunks after it are dropped. At most ``depth +
window + W`` staged chunks exist at once: the puller takes a staging slot
for each chunk in pull order before a worker sees it, so the chunk whose
turn it is always holds one. The phases ``pipeline.pack`` (the tee's
prepare on a worker) and ``pipeline.seq_wait`` (a staged chunk waiting
for its turn) join the producer's; :func:`ingest_hidden_frac` and
:func:`encode_hidden_frac` read them.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import threading

import numpy as np
import torch

from mpi_k_selection_tpu_torch import resource_protocols as _rp
from mpi_k_selection_tpu_torch.faults import policy as _fpol
from mpi_k_selection_tpu_torch.faults.inject import maybe_fault as _maybe_fault
from mpi_k_selection_tpu_torch.obs import ledger as _ledger
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.profiling import phase as _phase
from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

#: Classic double buffering: chunk i+1 staged while chunk i computes.
DEFAULT_PIPELINE_DEPTH = 2

#: Queue-depth ceiling: deeper rings only add memory, never overlap.
MAX_PIPELINE_DEPTH = 64

#: ``ingest_workers`` default: the one producer.
DEFAULT_INGEST_WORKERS = 1

#: Ceiling on ``ingest_workers``: a larger ask is a typo, not a bigger host.
MAX_INGEST_WORKERS = 64

#: ``ingest_workers="auto"`` resolves to ``min(this, cpu count)``.
INGEST_WORKERS_AUTO_CAP = 4

#: Producer threads carry this prefix (resource_protocols.py), so the test
#: suite's leaked-thread check covers them.
THREAD_NAME_PREFIX = _rp.PIPELINE_THREAD_PREFIX

#: The pooled plane's workers carry this prefix (``ksel-ingest-{pipe}-{w}``).
INGEST_THREAD_PREFIX = _rp.INGEST_THREAD_PREFIX

#: The producer side's phases on the pass's PhaseTimer, summed over its
#: threads: the pull, the chunk checks, the tee's prepare on a worker
#: (pooled plane), the staging and the tee's record write.
INGEST_PHASES = ("pipeline.produce", "pipeline.encode", "pipeline.pack", "pipeline.stage", "pipeline.spill")

#: The consumer's phase: time it waited for a staged chunk.
STALL_PHASE = "pipeline.stall"

#: A pooled worker's wait, with its chunk staged, for the chunk's turn in
#: order. Not ingest work (only the order waits), so not in INGEST_PHASES.
SEQ_WAIT_PHASE = "pipeline.seq_wait"

#: Host seconds and count of the host copies into pinned buffers, summed
#: over every stager (``reset()`` before a measured pass).
HOST_COPY = Stopwatch()

_NP_SIGNED = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def resolve_ingest_workers(workers) -> int:
    """The ``ingest_workers`` knob checked and resolved as the JAX
    package's: None -> 1, ``"auto"`` -> ``min(INGEST_WORKERS_AUTO_CAP,
    os.cpu_count())``, or an int in [1, MAX_INGEST_WORKERS]: 1 is the one
    producer, more the pooled plane (see the module docstring)."""
    if workers is None:
        return DEFAULT_INGEST_WORKERS
    if workers == "auto":
        return min(INGEST_WORKERS_AUTO_CAP, os.cpu_count() or 1)
    if isinstance(workers, bool) or not isinstance(workers, (int, np.integer)):
        raise ValueError(f"ingest_workers must be 'auto' or an integer >= 1, got {workers!r}")
    w = int(workers)
    if not 1 <= w <= MAX_INGEST_WORKERS:
        raise ValueError(f"ingest_workers={w} out of range [1, {MAX_INGEST_WORKERS}]")
    return w


def validate_pipeline_depth(depth) -> int:
    """``pipeline_depth`` as an int in [0, MAX_PIPELINE_DEPTH]
    (0 = synchronous; None = :data:`DEFAULT_PIPELINE_DEPTH`)."""
    if depth is None:
        return DEFAULT_PIPELINE_DEPTH
    if isinstance(depth, bool) or not isinstance(depth, (int, np.integer)):
        raise ValueError(f"pipeline_depth must be an integer >= 0 (0 = synchronous), got {depth!r}")
    d = int(depth)
    if not 0 <= d <= MAX_PIPELINE_DEPTH:
        raise ValueError(f"pipeline_depth={d} out of range [0, {MAX_PIPELINE_DEPTH}]")
    return d


def resolve_device(device) -> torch.device:
    """The device a stream is staged to: ``"cuda"`` by default, a CUDA
    device with its index made explicit, or the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"streams are staged to a CUDA device or the CPU, got {dev}")
    return dev


def _as_device(d) -> torch.device:
    """One ``devices`` entry as a torch.device that exists here: a CUDA
    entry names a present card (its index made explicit), a CPU entry
    keeps its index (``cpu:1`` is a slot of its own)."""
    if not isinstance(d, (str, torch.device)):
        raise ValueError(f"devices entries must be torch devices or device strings, got {d!r}")
    try:
        dev = torch.device(d)
    except RuntimeError:
        raise ValueError(f"devices entries must be torch devices or device strings, got {d!r}") from None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"devices entry {d!r} names a CUDA card, and no CUDA card is present")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"devices entry {d!r} names a card that is not there ({torch.cuda.device_count()} present)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"streams are staged to CUDA devices or the CPU, got devices entry {d!r}")
    return dev


def resolve_stream_devices(devices, device=None) -> tuple:
    """The ``devices`` ingest knob as a tuple of slots, with the JAX
    package's rules and messages:

    - ``None`` -> ``(None,)``: the single-slot path (every chunk on the
      stream's ``device``);
    - an int ``p >= 1``: the first ``min(p, torch.cuda.device_count())``
      cards, or, when the stream's ``device`` is the CPU, ``p`` indexed CPU
      slots ``cpu:0 .. cpu:p-1`` (one process's stand-in for cards);
    - a sequence of torch devices or device strings, used as given: its
      order fixes the slots, and an entry may repeat (two slots on one
      card). A CUDA entry must name a card that is present.

    ``bool``, ``p < 1``, an empty sequence and any other entry are
    errors. Resolved on the caller's thread, before a producer starts."""
    if devices is None:
        return (None,)
    if isinstance(devices, bool):
        raise ValueError(f"devices must be an int >= 1 or a device sequence, got {devices!r}")
    if isinstance(devices, (int, np.integer)):
        p = int(devices)
        if p < 1:
            raise ValueError(f"devices={p} out of range (need >= 1)")
        if resolve_device(device).type == "cpu":
            return tuple(torch.device("cpu", i) for i in range(p))
        return tuple(torch.device("cuda", i) for i in range(min(p, torch.cuda.device_count())))
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("devices sequence must not be empty")
        return tuple(_as_device(d) for d in devices)
    raise ValueError(
        f"devices must be None, an int >= 1, or a sequence of torch devices, got {type(devices).__name__!r}"
    )


def resolve_ingest(device, devices) -> tuple:
    """``(device, devs)``: the stream's device and its ingest slots
    (:func:`resolve_stream_devices`). With ``devices``, the stream's device
    is its first slot (the depth-0 path stages there); a ``device`` given
    too must agree: the slots' type, and one of them when it names an
    index. Disagreeing knobs raise a ValueError."""
    devs = resolve_stream_devices(devices, device)
    if devs == (None,):
        return resolve_device(device), devs
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type for d in devs) or (want.index is not None and want not in devs):
            raise ValueError(
                f"device={str(want)!r} and devices={[str(d) for d in devs]} disagree: with devices, device must be "
                "their type or one of them (or left None)"
            )
    return devs[0], devs


class StagingPool:
    """Free lists of pinned host buffers (uint8 tensors), keyed by
    ``(bytes, device)``: a stream's chunks are mostly of one size, and
    every pass replays the same chunking, so a released buffer serves the
    next chunk of its size. A buffer goes back only after its copy to the
    card has read it (:meth:`HostStager.to_device`). The pool keeps at
    most ``max_per_key`` buffers a key and ``max_bytes`` in all (the
    oldest go first). ``peak_live_bytes`` is the most bytes handed out and
    not yet released at once, ``peak_bytes`` that plus the free lists.
    The limits are the JAX ``StagingPool``'s. The free buffers stay pinned
    (page-locked host memory) after a pass returns, until :meth:`clear`.
    Thread-safe: every stager of every pass shares it."""

    def __init__(self, *, max_per_key: int = 4, max_bytes: int = 1 << 31):
        self._lock = threading.Lock()
        self._free: dict = {}  # ksel: guarded-by[_lock]
        self._order: list = []  # ksel: guarded-by[_lock] ((key, nbytes), oldest first)
        self._bytes = 0  # ksel: guarded-by[_lock] (free)
        self._live = 0  # ksel: guarded-by[_lock] (handed out)
        self.max_per_key = int(max_per_key)
        self.max_bytes = int(max_bytes)
        self.hits = self.misses = 0
        self.peak_live_bytes = self.peak_bytes = 0

    @staticmethod
    def _key(nbytes: int, device) -> tuple:
        return int(nbytes), str(device)

    def acquire(self, nbytes: int, device) -> torch.Tensor:
        """A pinned buffer of ``nbytes`` for a copy to ``device``: a
        released one of that key, else a new one."""
        key = self._key(nbytes, device)
        buf = None
        with self._lock:
            bufs = self._free.get(key)
            if bufs:
                buf = bufs.pop()
                self._bytes -= nbytes
                self._order.remove((key, nbytes))
                self.hits += 1
                _ledger.LEDGER.set_bytes("staging_pool", None, self._bytes)
            else:
                self.misses += 1
            self._live += nbytes
            self.peak_live_bytes = max(self.peak_live_bytes, self._live)
            self.peak_bytes = max(self.peak_bytes, self._live + self._bytes)
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def release(self, buf: torch.Tensor, device) -> None:
        """Hand a buffer back (its copy has finished reading it)."""
        nbytes = buf.numel()
        key = self._key(nbytes, device)
        with self._lock:
            self._live -= nbytes
            bufs = self._free.setdefault(key, [])
            if len(bufs) >= self.max_per_key:
                return
            bufs.append(buf)
            self._order.append((key, nbytes))
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._order:
                old_key, old_bytes = self._order.pop(0)
                self._free[old_key].pop(0)
                self._bytes -= old_bytes
            _ledger.LEDGER.set_bytes("staging_pool", None, self._bytes)

    @property
    def resident_bytes(self) -> int:
        """Bytes held in the free lists."""
        with self._lock:
            return self._bytes

    @property
    def live_bytes(self) -> int:
        """Bytes handed out and not yet released."""
        with self._lock:
            return self._live

    def reset_peaks(self) -> None:
        with self._lock:
            self.peak_live_bytes = self._live
            self.peak_bytes = self._live + self._bytes

    def clear(self) -> None:
        """Drop every free buffer (buffers handed out stay counted)."""
        with self._lock:
            self._free.clear()
            self._order.clear()
            self._bytes = 0
            _ledger.LEDGER.set_bytes("staging_pool", None, 0)


#: The pool every stager draws from: up to 2 GiB of pinned buffers stay
#: held between passes, until ``STAGING_POOL.clear()``.
STAGING_POOL = StagingPool()

_LIVE_LOCK = threading.Lock()
_LIVE_STAGED = 0  # ksel: guarded-by[_LIVE_LOCK]


def _live_add(delta: int) -> None:
    global _LIVE_STAGED
    with _LIVE_LOCK:
        _LIVE_STAGED += delta


def live_staged_keys() -> int:
    """The :class:`StagedKeys` staged and not yet released: 0 between
    passes (a chunk held past its pass is a leaked staging slot)."""
    with _LIVE_LOCK:
        return _LIVE_STAGED


@dataclasses.dataclass
class StagedKeys:
    """One chunk on the device: ``data`` holds ``n_valid`` raw words (keyed
    under ``key_op``/``key_xor``, utils/dtypes.py:key_fold) followed by
    ``pad`` pad words that count as key 0. :meth:`release` frees the
    staging slot and the pinned buffer once every result depending on the
    chunk is on the host; it is idempotent.

    ``staged`` says the producer staged the chunk to a round-robin slot,
    by the JAX package's rule: a histogram pass at depth >= 1, and the
    collect, certificate, sketch and monitor passes only with ``devices``
    (every other chunk is staged to the stream's device in turn).
    ``device_slot`` is the index of its card in the ``devices`` tuple
    (None without ``devices``), and ``tee_slot`` the slot a spill record
    of the chunk names (the round-robin cursor; a depth-0 chunk's replayed
    record keeps its own)."""

    data: torch.Tensor
    n_valid: int
    key_op: str = "none"
    key_xor: int = 0
    on_release: object = None  # returns the staging slot and the pinned buffer
    tee_slot: int | None = None
    device_slot: int | None = None
    staged: bool = False
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    @property
    def size(self) -> int:
        return self.n_valid

    @property
    def pad(self) -> int:
        return self.data.numel() - self.n_valid

    def release(self) -> None:
        with self._lock:
            hook, self.on_release = self.on_release, None
            # an empty tensor of its own, not a view: a released chunk that
            # something still references (an exception's traceback holds the
            # frames of a failed pass) must not keep its device memory
            self.data = self.data.new_empty(0)
        if hook is not None:
            hook()


class HostStager:
    """Copies host chunks to one CUDA device on a side stream of its own,
    through pinned buffers from :data:`STAGING_POOL`; the compute stream
    waits for each copy before any kernel reads it. A pinned buffer
    returns to the pool when its chunk is released, after its copy's
    event. The device buffer belongs to the side stream: the consumer
    frees it (:meth:`StagedKeys.release`) only once the work that read it
    has finished (the executor waits on that work's event; its unwind path
    synchronizes the device first), so the side stream may reuse the
    memory at once."""

    def __init__(self, device: torch.device, compute_stream):
        self._device = device
        self._compute = compute_stream
        self._copy = torch.cuda.Stream(device=device)

    def to_device(self, host: torch.Tensor):
        """``(device tensor, give_back)``: ``host`` copied to the card;
        ``give_back()`` returns the pinned buffer once the copy is done."""
        nbytes = host.numel() * host.element_size()
        buf = STAGING_POOL.acquire(nbytes, self._device)
        pinned = buf.view(host.dtype)
        with HOST_COPY.timing():
            pinned.copy_(host)
        with torch.cuda.stream(self._copy):
            out = torch.empty(host.numel(), dtype=host.dtype, device=self._device)
            out.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event(blocking=True)  # a host wait sleeps, not spins
            done.record(self._copy)
        self._compute.wait_event(done)

        def give_back():
            done.synchronize()  # the copy has read the buffer
            STAGING_POOL.release(buf, self._device)

        return out, give_back


def _bucket_elems(n: int) -> int:
    """The JAX package's power-of-two staging bucket of an ``n``-element
    chunk (chunks past 2^30 stay unpadded: their ceiling would cross the
    2^31 per-chunk counter bound). The port stages each chunk at its own
    length; spill records carry this bucket in their header as the JAX
    package's do."""
    bucket = 1 << max(0, n - 1).bit_length()
    return n if bucket >= 1 << 31 else bucket


def _raw_words(c) -> torch.Tensor:
    """A normalized chunk (1-D numpy array or tensor) as a tensor of its
    own bits in the signed integer dtype of its width (no copy)."""
    if isinstance(c, torch.Tensor):
        return _dt.bit_view(c.contiguous())
    c = np.ascontiguousarray(c)
    return torch.from_numpy(c.view(_NP_SIGNED[c.dtype.itemsize]))


def _chain(hooks):
    hooks = [h for h in hooks if h is not None]
    if not hooks:
        return None

    def run():
        for h in hooks:
            h()

    return run


def stage_chunk(c, dtype: torch.dtype, device: torch.device, stager=None, on_release=None, *, tee_slot=None,
                device_slot=None, staged=False) -> StagedKeys:
    """Stage one normalized chunk ``c`` of ``dtype`` on ``device`` (see the
    module docstring); ``stager`` (a :class:`HostStager`) carries host
    chunks to a CUDA device (a chunk stays where it is on the CPU, whatever
    the CPU slot's index). ``on_release`` runs at release, after the
    pinned buffer has gone back; the slot fields are the
    :class:`StagedKeys`'. A replayed spill record (streaming/spill.py:
    ``SpillChunk``) holds keys already: they are staged as they are
    (sub-32-bit keys widened on the device). The staged bytes are booked
    in the ledger's ``staging`` pool of ``device`` until release."""
    from mpi_k_selection_tpu_torch.streaming.spill import SpillChunk

    is_keys = isinstance(c, SpillChunk)
    raw = _raw_words(c.keys if is_keys else c)
    give_back = None
    if raw.device.type != device.type or (device.type == "cuda" and raw.device != device):
        if raw.device.type == "cpu":
            raw, give_back = stager.to_device(raw)
        else:
            raw = raw.to(device)
    bits = _dt.key_bits(dtype)
    if is_keys:
        keys, op, xor = (raw.to(torch.int32) & ((1 << bits) - 1) if bits < 32 else raw), "none", 0
    elif bits < 32:  # widened to 32-bit keys on the device
        keys, op, xor = _dt.to_sortable_bits(raw.view(dtype)), "none", 0
    else:
        fold = _dt.key_fold(dtype)
        keys, op, xor = raw, fold[0], fold[1] if fold[0] == "xor" else 0
    label, nbytes = str(device), keys.numel() * keys.element_size()
    _ledger.LEDGER.adjust_bytes("staging", label, nbytes)
    _live_add(1)

    def unbook():
        _ledger.LEDGER.adjust_bytes("staging", label, -nbytes)
        _live_add(-1)
    return StagedKeys(keys, raw.numel(), op, xor, _chain([give_back, unbook, on_release]), tee_slot=tee_slot,
                      device_slot=device_slot, staged=staged)


class InflightWindow:
    """FIFO window of in-flight per-chunk work: at most ``window`` handles
    pending, finished strictly in push order, so the host folds follow
    chunk order. ``occupancy`` (an obs/metrics.py Histogram, optional)
    samples the pending count at every push."""

    def __init__(self, window: int, finish, occupancy=None):
        self._window = max(1, int(window))
        self._finish = finish
        self._occupancy = occupancy
        self._q: collections.deque = collections.deque()

    def push(self, handle) -> None:
        self._q.append(handle)
        if self._occupancy is not None:
            self._occupancy.observe(len(self._q))
        if len(self._q) >= self._window:
            self._finish(self._q.popleft())

    def drain(self) -> None:
        while self._q:
            self._finish(self._q.popleft())

    def clear_pending(self) -> list:
        """Drop every pending handle unfinished, oldest first (the unwind
        path releases their staged chunks)."""
        items = list(self._q)
        self._q.clear()
        return items


@dataclasses.dataclass
class _Raised:
    exc: BaseException


_DONE = object()


class SlotCursor:
    """Where each chunk of a pass is staged, and the slots it names: with
    ``staged`` (the producer stages to round-robin slots, see
    :class:`StagedKeys`) chunk *j* goes to ``devs[j % p]`` (a replayed
    spill record to its own slot modulo ``p``; empty chunks do not advance
    the cursor) and its spill record names ``j % p``; else every chunk goes
    to ``device`` and names no slot. Resolved on the caller's thread."""

    def __init__(self, device: torch.device, devs: tuple, staged: bool):
        self.device = device
        self.devs = devs
        self.staged = staged
        self._next = 0

    def place(self, c) -> dict:
        """``stage_chunk``'s placement of one non-empty chunk: the target
        device and the slot fields."""
        from mpi_k_selection_tpu_torch.streaming.spill import SpillChunk

        if not self.staged:
            return dict(device=self.device, tee_slot=None, device_slot=None, staged=False)
        replay = c.device_slot if isinstance(c, SpillChunk) else None
        if replay is None:
            cursor = self._next % len(self.devs)
            self._next += 1
        else:
            cursor = replay % len(self.devs)
        dev = self.devs[cursor]
        if dev is None:  # no devices: the stream's device, no slot
            return dict(device=self.device, tee_slot=cursor, device_slot=None, staged=True)
        return dict(device=dev, tee_slot=cursor, device_slot=self.devs.index(dev), staged=True)

    def cuda_devices(self) -> list:
        """The distinct CUDA devices the pass stages onto."""
        devs = [self.device] + [d for d in self.devs if d is not None]
        return list(dict.fromkeys(d for d in devs if d.type == "cuda"))


@dataclasses.dataclass
class _IngestTask:
    """One chunk of the pooled plane, as the puller hands it to a worker:
    its turn ``seq``, the normalized chunk, the stream dtype, its placement
    (:meth:`SlotCursor.place`) and its ``"stage"`` fault index, all fixed in
    pull order; or the puller's ``error``, which takes the next turn."""

    seq: int
    chunk: object = None
    dtype: object = None
    place: dict | None = None
    fault_index: int = 0
    error: BaseException | None = None


class ChunkPipeline:
    """Background producer of ``(StagedKeys, dtype)`` pairs: the pipelined
    twin of the synchronous chunk iterator (streaming/chunked.py:
    ``_iter_staged``), with the same pairs, order, checks and errors.
    ``dtype`` is the stream dtype to hold chunks to (None: the first
    chunk's). ``cursor`` (a :class:`SlotCursor`) places each chunk; each
    card it names gets a :class:`HostStager` of its own. ``window`` is the
    consumer's in-flight bundles: at most ``depth + window`` staged chunks
    exist at once (``depth + window + workers`` in the pooled plane).
    ``spill`` (a streaming/spill.py ``SpillWriter``) tees every chunk's
    host keys to a spill generation, each record naming the chunk's
    ``tee_slot``: on the producer thread, or prepared on a worker and
    written in the sequencer's turn. ``timer`` (a PhaseTimer) times the
    producer's ``pipeline.produce`` / ``encode`` / ``spill`` / ``stage``
    phases (with ``pack`` and ``seq_wait`` in the pooled plane) and the
    consumer's ``pipeline.stall``.

    ``workers`` (resolved by :func:`resolve_ingest_workers`) picks the
    data plane: 1 is the one producer, more the puller, the workers and
    the reorder sequencer of the module docstring.

    Each chunk staged to a slot (``StagedKeys.staged``, the JAX package's
    staging rule) passes the ``"stage"`` fault site first, keyed by the
    pass's count of staged chunks, before any buffer is taken; ``retry`` (a
    faults/policy.py RetryPolicy, or None) retries a transient failure of
    it in place, and ``obs`` receives the retry events."""

    _ids = itertools.count()

    def __init__(self, src, dtype=None, *, depth: int, cursor: SlotCursor, window: int = 1, spill=None,
                 timer=None, retry=None, obs=None, workers=1):
        self._src = src
        self._dtype = dtype
        self._spill = spill  # the pass-0 tee's SpillWriter, appended to in chunk order
        self._retry = retry
        self._obs = obs
        self._depth = validate_pipeline_depth(depth)
        if self._depth == 0:
            raise ValueError("ChunkPipeline requires pipeline_depth >= 1; depth 0 is the synchronous path")
        self._pool_n = resolve_ingest_workers(workers)
        self._cursor = cursor
        self._timer = timer
        # the staged chunks queued, in the consumer's window and in its hand
        # (and, pooled, one a worker: staged and waiting for its turn)
        self._q: queue.Queue = queue.Queue()
        pooled = self._pool_n > 1
        self._slots = threading.Semaphore(self._depth + max(1, int(window)) + (self._pool_n if pooled else 0))
        self._stop = threading.Event()
        self._abort = threading.Event()  # pooled: an error has reached the consumer
        # the streams the consumer's kernels run on, captured on its thread
        self._compute = {d: torch.cuda.current_stream(d) for d in cursor.cuda_devices()}
        self._workers: list = []
        pipe_id = next(self._ids)
        if pooled:
            # raw chunks waiting for a worker (each already holds its slot)
            self._tasks: queue.Queue = queue.Queue(maxsize=self._pool_n)
            self._cond = threading.Condition()
            self._next_seq = 0  # ksel: guarded-by[_cond] (the turn being handed out)
            self._total = None  # ksel: guarded-by[_cond] (the task count, once the source ends)
            self._done_sent = False  # ksel: guarded-by[_cond]
            self._thread = threading.Thread(
                target=self._pull, name=f"{THREAD_NAME_PREFIX}-{pipe_id}", daemon=True
            )
            for w in range(self._pool_n):
                t = threading.Thread(
                    target=self._ingest_worker, name=f"{INGEST_THREAD_PREFIX}-{pipe_id}-{w}", daemon=True
                )
                self._workers.append(t)
                t.start()
        else:
            self._thread = threading.Thread(
                target=self._produce, name=f"{THREAD_NAME_PREFIX}-{pipe_id}", daemon=True
            )
        self._thread.start()

    def _halted(self) -> bool:
        """True once no further chunk may reach the consumer: it closed the
        pipeline, or an error already reached it (pooled plane)."""
        return self._stop.is_set() or self._abort.is_set()

    def _acquire_slot(self) -> bool:
        """Wait for a staging slot, yielding every 50 ms to honour a
        consumer-side close."""
        while not self._halted():
            if self._slots.acquire(timeout=0.05):
                return True
        return False

    def _stagers(self) -> dict:
        """This thread's :class:`HostStager` a card (its own copy stream),
        with the stream's card made this thread's current device."""
        if self._compute:
            torch.cuda.set_device(self._cursor.device)  # this thread stages to the stream's card
        return {d: HostStager(d, s) for d, s in self._compute.items()}

    def _produce(self) -> None:
        from mpi_k_selection_tpu_torch.streaming.chunked import _chunk_dtype, _normalize_chunk, _tee

        keys = None  # the staged chunk in hand; None once the consumer owns it
        timer = self._timer
        try:
            stagers = self._stagers()
            dtype = self._dtype
            staged_i = 0  # the stage fault site's stable key: a retry of a chunk shares it
            it = iter(self._src())
            while True:
                with _phase(timer, "pipeline.produce"):
                    chunk = next(it, _DONE)
                if chunk is _DONE or self._stop.is_set():
                    break
                with _phase(timer, "pipeline.encode"):
                    c = _normalize_chunk(chunk, dtype)
                if c is None:
                    continue
                if dtype is None:
                    dtype = _chunk_dtype(c)
                place = self._cursor.place(c)
                if not self._acquire_slot():
                    return
                with _phase(timer, "pipeline.stage"):
                    try:
                        keys = _fpol.retry_call(
                            lambda i=staged_i, c=c, dtype=dtype, place=place: self._stage(c, dtype, stagers, place, i),
                            self._retry, site="stage", obs=self._obs)
                    except BaseException:
                        self._slots.release()  # nothing was staged into the slot
                        raise
                staged_i += place["staged"]
                if self._spill is not None:
                    with _phase(timer, "pipeline.spill"):
                        _tee(self._spill, c, dtype, place["tee_slot"])
                self._q.put((keys, dtype))
                keys = None
            if not self._stop.is_set():
                self._q.put(_DONE)
        except BaseException as e:  # re-raised by the consumer
            if keys is not None:
                keys.release()
            self._q.put(_Raised(e))

    def _stage(self, c, dtype, stagers, place, index):
        """One staging attempt: the ``"stage"`` fault site (a chunk staged to
        a slot only, as the JAX package stages), before any buffer is
        taken, so a retried attempt has nothing to unwind; then the chunk to
        its card."""
        if place["staged"]:
            _maybe_fault("stage", index)
        return stage_chunk(c, dtype, stager=stagers.get(place["device"]), on_release=self._slots.release, **place)

    # -- the pooled plane (workers > 1) -----------------------------------

    def _submit(self, task) -> bool:
        """Hand a task (or a worker's stop sentinel, None) to the workers,
        yielding every 50 ms to honour a close or an error released."""
        while not self._halted():
            try:
                self._tasks.put(task, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _pull(self) -> None:
        """The puller: the chunks in source order, their checks, and each
        chunk's slot, placement and fault index, before any worker sees
        it. A chunk takes its staging slot here, in pull order."""
        from mpi_k_selection_tpu_torch.streaming.chunked import _chunk_dtype, _normalize_chunk

        timer = self._timer
        dtype = self._dtype
        staged_i = 0
        seq = 0
        it = None
        try:
            it = iter(self._src())
            while not self._halted():
                with _phase(timer, "pipeline.produce"):
                    chunk = next(it, _DONE)
                if chunk is _DONE:
                    break
                with _phase(timer, "pipeline.encode"):
                    c = _normalize_chunk(chunk, dtype)
                if c is None:
                    continue
                if dtype is None:
                    dtype = _chunk_dtype(c)
                place = self._cursor.place(c)
                if not self._acquire_slot():
                    return
                if not self._submit(_IngestTask(seq, c, dtype, place, staged_i)):
                    self._slots.release()
                    return
                staged_i += place["staged"]
                seq += 1
            if not self._halted():
                self._finish_stream(seq)
        except BaseException as e:
            # the error takes the next turn: it reaches the consumer after
            # every earlier chunk, as the one producer's does
            if self._submit(_IngestTask(seq, error=e)):
                self._finish_stream(seq + 1)
        finally:
            # a pooled spill decode joins its threads when its generator closes
            close = getattr(it, "close", None)
            if close is not None:
                close()
            for _ in self._workers:  # one sentinel a worker, after every task
                if not self._submit(None):
                    break

    def _finish_stream(self, total: int) -> None:
        """Publish the task count; whoever sees the sequencer reach it (the
        last chunk's worker, or this puller) sends the one ``_DONE``."""
        with self._cond:
            self._total = total
            send = self._next_seq >= total and not self._done_sent
            self._done_sent |= send
        if send:
            self._q.put(_DONE)

    def _advance_seq(self) -> None:
        """Pass the turn on, once this turn's chunk or error is queued."""
        with self._cond:
            self._next_seq += 1
            send = self._total is not None and self._next_seq >= self._total and not self._done_sent
            self._done_sent |= send
            self._cond.notify_all()
        if send:
            self._q.put(_DONE)

    def _ingest_worker(self) -> None:
        stagers = setup_error = None
        try:
            stagers = self._stagers()
        except BaseException as e:  # reaches the consumer at this worker's first chunk
            setup_error = e
        while not self._stop.is_set():
            try:
                task = self._tasks.get(timeout=0.05)
            except queue.Empty:
                if self._abort.is_set():
                    return
                continue
            if task is None:
                return
            if setup_error is not None and task.error is None:
                self._slots.release()
                task.error = setup_error
            self._run_task(task, stagers)

    def _run_task(self, task: _IngestTask, stagers) -> None:
        """One chunk on a worker: its staging (and the v1 tee's prepare),
        order-free; then its turn, in which the tee record is written and
        the chunk (or the error) is handed to the consumer."""
        from mpi_k_selection_tpu_torch.streaming.chunked import _np_dtype, _tee_keys

        timer = self._timer
        keys = prep = None
        error = task.error
        if error is None and self._halted():
            self._slots.release()  # nothing was staged into the slot
            return
        if error is None:
            try:
                with _phase(timer, "pipeline.stage"):
                    keys = _fpol.retry_call(
                        lambda: self._stage(task.chunk, task.dtype, stagers, task.place, task.fault_index),
                        self._retry, site="stage", obs=self._obs)
            except BaseException as e:
                self._slots.release()  # nothing was staged into the slot
                error = e
        if error is None and self._spill is not None:
            try:
                with _phase(timer, "pipeline.pack"):
                    prep = self._spill.prepare(_tee_keys(task.chunk, task.dtype), _np_dtype(task.dtype))
            except BaseException as e:
                keys.release()
                keys, error = None, e
        with _phase(timer, SEQ_WAIT_PHASE), self._cond:
            while self._next_seq != task.seq and not self._halted():
                self._cond.wait(0.05)
            my_turn = self._next_seq == task.seq and not self._halted()
        if not my_turn:  # the consumer closed, or an earlier error reached it
            if keys is not None:
                keys.release()
            return
        try:
            if prep is not None:
                try:
                    with _phase(timer, "pipeline.spill"):
                        self._spill.append_prepared(prep, device_slot=task.place["tee_slot"])
                except BaseException as e:
                    keys.release()
                    keys, error = None, e
            if error is None:
                self._q.put((keys, task.dtype))
                keys = None
            else:
                self._q.put(_Raised(error))
                self._abort.set()  # every chunk after this one is dropped
        finally:
            self._advance_seq()

    # -- the consumer's side ----------------------------------------------

    def _alive(self) -> bool:
        return self._thread.is_alive() or any(t.is_alive() for t in self._workers)

    def _get(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._alive() and self._q.empty():
                    raise RuntimeError("streaming pipeline producer died without a result") from None

    def __iter__(self):
        while True:
            with _phase(self._timer, STALL_PHASE):
                item = self._get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item

    def close(self) -> None:
        """Stop the producer (or the puller and the workers), release the
        chunks staged that the consumer never took (queued, or held by a
        worker waiting for its turn), and join every thread. Idempotent."""
        self._stop.set()

        def drain():
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return
                if isinstance(item, tuple):
                    item[0].release()

        drain()
        self._thread.join(timeout=10.0)
        for t in self._workers:
            t.join(timeout=10.0)
        drain()  # a put that landed while a thread saw the stop flag
        if self._workers:
            while True:  # chunks no worker took hold no buffer
                try:
                    self._tasks.get_nowait()
                except queue.Empty:
                    break
        import warnings

        for t in [self._thread, *self._workers]:
            if t.is_alive():
                warnings.warn(
                    f"streaming pipeline thread {t.name} did not stop within 10 s of close(); "
                    + ("its chunk source is blocked mid-read and " if t is self._thread else "")
                    + "the thread has been abandoned (daemon)",
                    RuntimeWarning,
                    stacklevel=2,
                )


def ingest_hidden_frac(timer) -> float | None:
    """The share of the producer side's time (:data:`INGEST_PHASES`) the
    consumer did not wait for: ``1 - stall / ingest``, clamped to [0, 1]
    (the JAX package's formula). None when the timer holds no ingest
    phase (a depth-0 run)."""
    ingest = sum(timer.phases.get(p, 0.0) for p in INGEST_PHASES)
    if ingest <= 0.0:
        return None
    stall = timer.phases.get(STALL_PHASE, 0.0)
    return max(0.0, min(1.0, 1.0 - stall / ingest))


def encode_hidden_frac(timer) -> float | None:
    """The pooled plane's cut of :func:`ingest_hidden_frac`: the share of
    the work a pool can divide (``pipeline.encode``, ``pack`` and
    ``stage``) the consumer did not wait for, ``1 - stall / work`` clamped
    to [0, 1] (the JAX package's formula). None without such phases."""
    work = sum(timer.phases.get(p, 0.0) for p in ("pipeline.encode", "pipeline.pack", "pipeline.stage"))
    if work <= 0.0:
        return None
    stall = timer.phases.get(STALL_PHASE, 0.0)
    return max(0.0, min(1.0, 1.0 - stall / work))
