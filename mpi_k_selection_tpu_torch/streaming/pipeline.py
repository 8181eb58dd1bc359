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

``ingest_workers`` (:func:`resolve_ingest_workers`) is taken and checked
as the JAX package takes it, but every width runs the one producer above:
the JAX package's pool of ingest workers is not ported. On an H100 host a
pool of 2 and 4 workers moved neither the streamed median's wall time nor
the card's idle share, and the host copy into pinned memory ran at one
rate from one thread or two (PERF.md §6); the pool waits for a workload
that shows it winning (ROADMAP Queue 1 item 3a).
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

#: ``ingest_workers`` default (every width runs the one producer).
DEFAULT_INGEST_WORKERS = 1

#: Ceiling on ``ingest_workers``: a larger ask is a typo, not a bigger host.
MAX_INGEST_WORKERS = 64

#: ``ingest_workers="auto"`` resolves to ``min(this, cpu count)``.
INGEST_WORKERS_AUTO_CAP = 4

#: Producer threads carry this prefix (resource_protocols.py), so the test
#: suite's leaked-thread check covers them.
THREAD_NAME_PREFIX = _rp.PIPELINE_THREAD_PREFIX

#: Host seconds and count of the host copies into pinned buffers, summed
#: over every stager (``reset()`` before a measured pass).
HOST_COPY = Stopwatch()

_NP_SIGNED = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def resolve_ingest_workers(workers) -> int:
    """The ``ingest_workers`` knob checked and resolved as the JAX
    package's: None -> 1, ``"auto"`` -> ``min(INGEST_WORKERS_AUTO_CAP,
    os.cpu_count())``, or an int in [1, MAX_INGEST_WORKERS]. Every width
    runs the one producer (see the module docstring)."""
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
    unbook = lambda: _ledger.LEDGER.adjust_bytes("staging", label, -nbytes)  # noqa: E731
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


class ChunkPipeline:
    """Background producer of ``(StagedKeys, dtype)`` pairs: the pipelined
    twin of the synchronous chunk iterator (streaming/chunked.py:
    ``_iter_staged``), with the same pairs, order, checks and errors.
    ``dtype`` is the stream dtype to hold chunks to (None: the first
    chunk's). ``cursor`` (a :class:`SlotCursor`) places each chunk; each
    card it names gets a :class:`HostStager` of its own. ``window`` is the
    consumer's in-flight bundles: at most ``depth + window`` staged chunks
    exist at once. ``spill`` (a streaming/spill.py ``SpillWriter``) tees
    every chunk's host keys to a spill generation on the producer thread,
    each record naming the chunk's ``tee_slot``. ``timer`` (a PhaseTimer)
    times the producer's ``pipeline.produce`` / ``encode`` / ``spill`` /
    ``stage`` phases and the consumer's ``pipeline.stall``.

    Each chunk staged to a slot (``StagedKeys.staged``, the JAX package's
    staging rule) passes the ``"stage"`` fault site first, keyed by the
    pass's count of staged chunks, before any buffer is taken; ``retry`` (a
    faults/policy.py RetryPolicy, or None) retries a transient failure of
    it in place, and ``obs`` receives the retry events."""

    _ids = itertools.count()

    def __init__(self, src, dtype=None, *, depth: int, cursor: SlotCursor, window: int = 1, spill=None,
                 timer=None, retry=None, obs=None):
        self._src = src
        self._dtype = dtype
        self._spill = spill  # the pass-0 tee's SpillWriter, appended to on this thread
        self._retry = retry
        self._obs = obs
        self._depth = validate_pipeline_depth(depth)
        if self._depth == 0:
            raise ValueError("ChunkPipeline requires pipeline_depth >= 1; depth 0 is the synchronous path")
        self._cursor = cursor
        self._timer = timer
        # the staged chunks queued, in the consumer's window and in its hand
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(self._depth + max(1, int(window)))
        self._stop = threading.Event()
        # the streams the consumer's kernels run on, captured on its thread
        self._compute = {d: torch.cuda.current_stream(d) for d in cursor.cuda_devices()}
        self._thread = threading.Thread(
            target=self._produce, name=f"{THREAD_NAME_PREFIX}-{next(self._ids)}", daemon=True
        )
        self._thread.start()

    def _acquire_slot(self) -> bool:
        """Wait for a staging slot, yielding every 50 ms to honour a
        consumer-side close."""
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.05):
                return True
        return False

    def _produce(self) -> None:
        from mpi_k_selection_tpu_torch.streaming.chunked import _chunk_dtype, _normalize_chunk, _tee

        keys = None  # the staged chunk in hand; None once the consumer owns it
        timer = self._timer
        try:
            if self._compute:
                torch.cuda.set_device(self._cursor.device)  # this thread stages to the stream's card
            stagers = {d: HostStager(d, s) for d, s in self._compute.items()}
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

    def _get(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("streaming pipeline producer died without a result") from None

    def __iter__(self):
        while True:
            with _phase(self._timer, "pipeline.stall"):
                item = self._get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item

    def close(self) -> None:
        """Stop the producer, release the chunks it staged that the
        consumer never took, and join the thread. Idempotent."""
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
        drain()  # a put that landed while the producer saw the stop flag
        if self._thread.is_alive():
            import warnings

            warnings.warn(
                f"streaming pipeline producer {self._thread.name} did not stop within 10 s of close(); "
                "its chunk source is blocked mid-read and the thread has been abandoned (daemon)",
                RuntimeWarning,
                stacklevel=2,
            )
