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

from mpi_k_selection_tpu_torch.utils import dtypes as _dt
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

#: Producer threads carry this prefix (the JAX package's
#: ``resource_protocols.PIPELINE_THREAD_PREFIX``), so the test suite's
#: leaked-thread check covers them.
THREAD_NAME_PREFIX = "ksel-pipeline"

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


#: The pool every stager draws from: up to 2 GiB of pinned buffers stay
#: held between passes, until ``STAGING_POOL.clear()``.
STAGING_POOL = StagingPool()


@dataclasses.dataclass
class StagedKeys:
    """One chunk on the device: ``data`` holds ``n_valid`` raw words (keyed
    under ``key_op``/``key_xor``, utils/dtypes.py:key_fold) followed by
    ``pad`` pad words that count as key 0. :meth:`release` frees the
    staging slot and the pinned buffer once every result depending on the
    chunk is on the host; it is idempotent."""

    NO_SLOT = object()  # ``slot`` of a chunk that is not a replayed spill record

    data: torch.Tensor
    n_valid: int
    key_op: str = "none"
    key_xor: int = 0
    on_release: object = None  # returns the staging slot and the pinned buffer
    slot: object = NO_SLOT  # a replayed spill record's device slot (a tee keeps it)
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
            self.data = self.data[:0]
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


def stage_chunk(c, dtype: torch.dtype, device: torch.device, stager=None, on_release=None) -> StagedKeys:
    """Stage one normalized chunk ``c`` of ``dtype`` on ``device`` (see the
    module docstring); ``stager`` (a :class:`HostStager`) carries host
    chunks to a CUDA device. ``on_release`` runs at release, after the
    pinned buffer has gone back. A replayed spill record
    (streaming/spill.py: ``SpillChunk``) holds keys already: they are
    staged as they are (sub-32-bit keys widened on the device)."""
    from mpi_k_selection_tpu_torch.streaming.spill import SpillChunk

    is_keys = isinstance(c, SpillChunk)
    raw = _raw_words(c.keys if is_keys else c)
    give_back = None
    if raw.device != device:
        if raw.device.type == "cpu":
            raw, give_back = stager.to_device(raw)
        else:
            raw = raw.to(device)
    release = _chain([give_back, on_release])
    bits = _dt.key_bits(dtype)
    if is_keys:
        keys = raw.to(torch.int32) & ((1 << bits) - 1) if bits < 32 else raw
        return StagedKeys(keys, raw.numel(), on_release=release, slot=c.device_slot)
    if bits < 32:  # widened to 32-bit keys on the device
        return StagedKeys(_dt.to_sortable_bits(raw.view(dtype)), raw.numel(), on_release=release)
    fold = _dt.key_fold(dtype)
    return StagedKeys(raw, raw.numel(), fold[0], fold[1] if fold[0] == "xor" else 0, release)


class InflightWindow:
    """FIFO window of in-flight per-chunk work: at most ``window`` handles
    pending, finished strictly in push order, so the host folds follow
    chunk order."""

    def __init__(self, window: int, finish):
        self._window = max(1, int(window))
        self._finish = finish
        self._q: collections.deque = collections.deque()

    def push(self, handle) -> None:
        self._q.append(handle)
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


class ChunkPipeline:
    """Background producer of ``(StagedKeys, dtype)`` pairs: the pipelined
    twin of the synchronous chunk iterator (streaming/chunked.py:
    ``_iter_staged``), with the same pairs, order, checks and errors.
    ``dtype`` is the stream dtype to hold chunks to (None: the first
    chunk's). ``spill`` (a streaming/spill.py ``SpillWriter``) tees every
    chunk's host keys to a spill generation on the producer thread, each
    record naming ``spill_slot`` as its device slot."""

    _ids = itertools.count()

    def __init__(self, src, dtype=None, *, depth: int, device: torch.device, spill=None, spill_slot=None):
        self._src = src
        self._dtype = dtype
        self._spill = spill  # the pass-0 tee's SpillWriter, appended to on this thread
        self._spill_slot = spill_slot
        self._depth = validate_pipeline_depth(depth)
        if self._depth == 0:
            raise ValueError("ChunkPipeline requires pipeline_depth >= 1; depth 0 is the synchronous path")
        self._device = device
        # the staged chunks in the queue and in the consumer's hand: depth + 1
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(self._depth + 1)
        self._stop = threading.Event()
        # the stream the consumer's kernels run on, captured on its thread
        self._compute = torch.cuda.current_stream(device) if device.type == "cuda" else None
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
        try:
            stager = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)  # this thread stages to the stream's card
                stager = HostStager(self._device, self._compute)
            dtype = self._dtype
            for chunk in self._src():
                if self._stop.is_set():
                    return
                c = _normalize_chunk(chunk, dtype)
                if c is None:
                    continue
                if dtype is None:
                    dtype = _chunk_dtype(c)
                if self._spill is not None:
                    _tee(self._spill, c, dtype, self._spill_slot)
                if not self._acquire_slot():
                    return
                keys = stage_chunk(c, dtype, self._device, stager, on_release=self._slots.release)
                self._q.put((keys, dtype))
                keys = None
            self._q.put(_DONE)
        except BaseException as e:  # re-raised by the consumer
            if keys is not None:
                keys.release()
            self._q.put(_Raised(e))

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("streaming pipeline producer died without a result") from None
                continue
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
