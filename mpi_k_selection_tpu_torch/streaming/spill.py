"""Survivor spill store, format v1 (counterpart of
``mpi_k_selection_tpu/streaming/spill.py``).

Without a cache every pass of the streamed descent (streaming/chunked.py)
re-reads the whole source: a P-pass descent moves about P·N key bytes
over the host-to-card link when only pass 0 needs all N. The store
applies the reference CGM's discard step (``TODO-kth-problem-cgm.c``: the
L/E/G counts and the window rebase) to the stream:

- pass 0 tees each chunk's encoded keys to generation 0 (on the host, on
  the pipeline's producer thread);
- every later pass reads the previous generation, filters each chunk to
  the surviving prefixes on the card (the sweep kernel's tee part,
  streaming/executor.py) and writes only the compacted survivors as the
  next generation;
- one-shot sources become valid: passes >= 1 never touch the source.

A generation is a directory of records, one a chunk, in the JAX package's
format v1, byte for byte: a ``<8sIqqqq8s8sIQ`` header (magic, version,
record index, ``n_valid``, staging bucket, device slot, key and stream
dtype tags, CRC32 of the payload, payload bytes), then the keys at full
width. Any mismatch between a record and its writer's metadata raises
:class:`~mpi_k_selection_tpu_torch.errors.SpillRecordError` before a key
reaches a histogram. The JAX package's format v2 (prefix-packed records,
``pack_spill="auto"``) is refused with a
:class:`~mpi_k_selection_tpu_torch.errors.SpillError` that names ROADMAP
Queue 1 item 3d, which brings it; the pooled decode
(``iter_chunks(workers=)``) waits on item 3a.

Disk bound: a descent drops older generations as it goes, so an internal
store holds at most two generations (about 2·N·key_bytes at worst, with
duplicates; N·(1 + 1/2^b) typically), plus the kept generation 0 of a
one-shot run or a caller-owned store (about 3·N·key_bytes at worst).

Lifecycle: a store made by the descent lives in a ``ksel-spill-*``
directory (under ``spill_dir``, default the temp dir) and is removed on
every exit path. A caller-owned store keeps its generation 0 for later
calls (``refine``, the rank certificate, a second descent) until
``close()``.

This is the one module of the port's ``streaming/`` that writes files
(lint rule KSL008 allows only a path ending ``streaming/spill.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
import struct
import tempfile
import zlib

import numpy as np

from mpi_k_selection_tpu_torch.errors import SpillError, SpillRecordError
from mpi_k_selection_tpu_torch.streaming.pipeline import _bucket_elems
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

#: Directory prefix of every store (the JAX package's
#: ``resource_protocols.SPILL_DIR_PREFIX``, so the test suite's
#: leaked-directory check covers the port's stores).
SPILL_DIR_PREFIX = "ksel-spill-"

#: The ``spill=`` knob's string modes (a SpillStore is also accepted).
SPILL_MODES = ("auto", "off", "force")

_MAGIC = b"KSPILL1\x00"
_VERSION = 1
#: The JAX package's format v2 (prefix-packed records): refused here.
_VERSION_PACKED = 2
# magic, version, record index, n_valid, bucket, device slot (-1: none),
# key dtype tag, stream dtype tag, crc32 of the payload, payload bytes
_HEADER = struct.Struct("<8sIqqqq8s8sIQ")
# NumPy's dtype tag of ml_dtypes' bfloat16 is a bare 2-byte void, which
# np.dtype() reads back as void: the one tag mapped back by name
_BFLOAT16_TAG = "<V2"


def validate_spill_mode(spill):
    """Normalize the ``spill`` knob: one of :data:`SPILL_MODES`, or an open
    :class:`SpillStore` to tee into / read from (caller-owned lifecycle)."""
    if isinstance(spill, SpillStore):
        if spill.closed:
            raise SpillError("spill store is closed")
        return spill
    if spill in SPILL_MODES:
        return spill
    raise ValueError(f"spill must be one of {SPILL_MODES} or a SpillStore, got {spill!r}")


def _pack_dtype(dt) -> bytes:
    s = np.dtype(dt).str.encode("ascii")
    if len(s) > 8:  # pragma: no cover - no supported dtype exceeds '<u8'
        raise SpillError(f"dtype tag {s!r} exceeds the 8-byte record field")
    return s.ljust(8, b"\x00")


def _unpack_dtype(raw: bytes, path: str) -> np.dtype:
    try:
        tag = raw.rstrip(b"\x00").decode("ascii")
        return numpy_dtype("bfloat16") if tag == _BFLOAT16_TAG else np.dtype(tag)
    except (TypeError, UnicodeDecodeError) as e:
        raise SpillRecordError(f"spill record {path}: bad dtype tag {raw!r}") from e


@dataclasses.dataclass(frozen=True)
class SpillRecord:
    """On-disk metadata of one spilled chunk: the ``(chunk_index, bucket,
    dtype, device)`` key plus the payload's size and checksum. The header
    on disk repeats all of it, and the reader cross-checks both."""

    path: str
    chunk_index: int
    n_valid: int
    bucket: int
    device_slot: int | None
    key_dtype: np.dtype
    orig_dtype: np.dtype
    crc32: int
    nbytes: int
    version: int = _VERSION

    @property
    def logical_nbytes(self) -> int:
        return self.n_valid * self.key_dtype.itemsize


@dataclasses.dataclass(frozen=True)
class SpillChunk:
    """One replayed chunk: keys already encoded (host, key space) and the
    stream dtype they encode. The descent stages it without re-encoding
    (streaming/chunked.py: ``_normalize_chunk``)."""

    keys: np.ndarray
    orig_dtype: np.dtype
    device_slot: int | None
    chunk_index: int
    bucket: int


@dataclasses.dataclass(frozen=True)
class PreparedSpillRecord:
    """The order-free half of one append: keys checksummed, not yet given
    a record index or written (:meth:`SpillWriter.prepare`)."""

    n: int
    key_dtype: np.dtype
    orig_dtype: np.dtype
    version: int
    payload: np.ndarray
    crc: int


class SpillWriter:
    """Append-only writer of ONE generation, called from one thread per
    pass (the producer for the pass-0 tee, the consumer for the filtered
    survivor writes); ``commit`` or ``abort`` runs after the pass."""

    def __init__(self, store: "SpillStore", index: int, path: str):
        self.store = store
        self.index = index
        self.path = path
        os.makedirs(path)
        self._records: list[SpillRecord] = []
        self._count = 0
        self._done = False

    def prepare(self, keys: np.ndarray, orig_dtype) -> PreparedSpillRecord:
        """Ravel and checksum one chunk's keys (no index, no disk)."""
        keys = np.ascontiguousarray(keys).reshape(-1)
        return PreparedSpillRecord(
            n=int(keys.shape[0]), key_dtype=np.dtype(keys.dtype), orig_dtype=np.dtype(orig_dtype),
            version=_VERSION, payload=keys, crc=zlib.crc32(keys.data) & 0xFFFFFFFF,
        )

    def append_prepared(self, prep: PreparedSpillRecord, device_slot=None) -> SpillRecord:
        """Write one prepared record as the generation's next record."""
        if self._done:
            raise SpillError("spill generation already committed/aborted")
        slot = -1 if device_slot is None else int(device_slot)
        rec_path = os.path.join(self.path, f"r{self._count:08d}.kspill")
        bucket = _bucket_elems(prep.n)
        header = _HEADER.pack(
            _MAGIC, prep.version, self._count, prep.n, bucket, slot, _pack_dtype(prep.key_dtype),
            _pack_dtype(prep.orig_dtype), prep.crc, prep.payload.nbytes,
        )
        with open(rec_path, "wb") as f:
            f.write(header)
            f.write(prep.payload.data)
        rec = SpillRecord(
            path=rec_path, chunk_index=self._count, n_valid=prep.n, bucket=bucket, device_slot=device_slot,
            key_dtype=prep.key_dtype, orig_dtype=prep.orig_dtype, crc32=prep.crc,
            nbytes=int(prep.payload.nbytes), version=prep.version,
        )
        self._records.append(rec)
        self._count += 1
        return rec

    def append(self, keys: np.ndarray, orig_dtype, device_slot=None) -> SpillRecord:
        """Write one chunk's encoded keys (host, key space) as a record;
        ``orig_dtype`` is the stream dtype they encode."""
        return self.append_prepared(self.prepare(keys, orig_dtype), device_slot=device_slot)

    def commit(self) -> "SpillGeneration":
        """Finalize: register the generation with the store and return it."""
        if self._done:
            raise SpillError("spill generation already committed/aborted")
        self._done = True
        gen = SpillGeneration(self.store, self.index, self.path, tuple(self._records))
        self.store._register(gen)
        return gen

    def abort(self) -> None:
        """Drop every record written so far (idempotent): the unwind path
        when the pass feeding this generation raises."""
        if self._done:
            return
        self._done = True
        shutil.rmtree(self.path, ignore_errors=True)


class SpillGeneration:
    """One committed generation: an ordered, replayable set of records.
    ``as_source()`` is a chunk source for every streaming entry point;
    each read re-validates the records."""

    def __init__(self, store, index: int, path: str, records: tuple):
        self.store = store
        self.index = index
        self.path = path
        self.records = records
        self.dropped = False

    @property
    def nbytes(self) -> int:
        """Payload bytes on disk."""
        return sum(r.nbytes for r in self.records)

    @property
    def logical_nbytes(self) -> int:
        """Full-width key bytes a read streams into its consumers (equal to
        :attr:`nbytes` in format v1)."""
        return sum(r.logical_nbytes for r in self.records)

    @property
    def keys(self) -> int:
        return sum(r.n_valid for r in self.records)

    def iter_chunks(self, mmap: bool = False, filter_specs=None):
        """Yield every record as a :class:`SpillChunk`, validating headers,
        sizes and checksums (a mismatch raises SpillRecordError). ``mmap``
        serves each payload as a read-only ``np.memmap`` view (checksummed
        in place) instead of a heap copy. ``filter_specs`` (a
        ``(resolved_bits, prefix)`` union) prunes nothing in format v1
        (records have no segment directory) beyond skipping empty ones;
        the consumers' own filters select the keys."""
        if self.dropped:
            raise SpillError(
                f"spill generation {self.index} was dropped (or its store closed); "
                "it can no longer serve as a chunk source"
            )
        for rec in self.records:
            chunk = _read_record(rec, mmap=mmap)
            if filter_specs is not None and chunk.keys.shape[0] == 0:
                continue
            yield chunk

    def as_source(self, mmap: bool = False, filter_specs=None):
        """Zero-arg callable returning a fresh record iterator: the
        replayable chunk-source form of streaming/chunked.py."""
        if not mmap and filter_specs is None:
            return self.iter_chunks
        specs = None if filter_specs is None else tuple((int(r), int(p)) for r, p in filter_specs)
        return functools.partial(self.iter_chunks, mmap=mmap, filter_specs=specs)

    def read_nbytes(self, filter_specs=None) -> int:
        """Bytes a (filtered) read of this generation touches on disk:
        every record whole in format v1."""
        return self.nbytes

    def read_keys(self, filter_specs=None) -> int:
        """Keys a (filtered) read streams into its consumers: all of them
        in format v1."""
        return self.keys

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpillGeneration(index={self.index}, records={len(self.records)}, keys={self.keys}, nbytes={self.nbytes})"


def _read_record(rec: SpillRecord, mmap: bool = False) -> SpillChunk:
    try:
        f = open(rec.path, "rb")
    except OSError as e:
        raise SpillRecordError(f"spill record {rec.path}: unreadable ({e})") from e
    with f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise SpillRecordError(f"spill record {rec.path}: truncated header ({len(head)} of {_HEADER.size} bytes)")
        magic, version, chunk_index, n_valid, bucket, slot, key_raw, orig_raw, crc, nbytes = _HEADER.unpack(head)
        if magic == _MAGIC and version == _VERSION_PACKED:
            raise SpillError(
                f"spill record {rec.path}: format v2 (prefix-packed, pack_spill='auto') is not read by this "
                "package yet: packed spill records are ROADMAP Queue 1 item 3d"
            )
        if magic != _MAGIC or version != _VERSION:
            raise SpillRecordError(f"spill record {rec.path}: bad magic/version ({magic!r}, {version})")
        key_dt = _unpack_dtype(key_raw, rec.path)
        orig_dt = _unpack_dtype(orig_raw, rec.path)
        meta = (version, chunk_index, n_valid, bucket, None if slot < 0 else slot, key_dt, orig_dt, crc, nbytes)
        want = (
            rec.version, rec.chunk_index, rec.n_valid, rec.bucket, rec.device_slot, rec.key_dtype,
            rec.orig_dtype, rec.crc32, rec.nbytes,
        )
        if meta != want:
            raise SpillRecordError(
                f"spill record {rec.path}: header does not match the writer's metadata "
                f"(header {meta}, expected {want})"
            )
        if nbytes != n_valid * key_dt.itemsize:
            raise SpillRecordError(
                f"spill record {rec.path}: payload size {nbytes} != {n_valid} x {key_dt.itemsize}-byte keys"
            )
        if not mmap:
            payload = bytearray(nbytes)  # writable: the keys become a tensor without a copy
            got = f.readinto(payload)
            if got != nbytes:
                raise SpillRecordError(f"spill record {rec.path}: truncated payload ({got} of {nbytes} bytes)")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise SpillRecordError(f"spill record {rec.path}: checksum mismatch (corrupt payload)")
            keys = np.frombuffer(payload, dtype=key_dt)
    if mmap:
        if n_valid == 0:  # pragma: no cover - writers skip empty chunks
            keys = np.empty((0,), key_dt)
        else:
            try:
                keys = np.memmap(rec.path, dtype=key_dt, mode="r", offset=_HEADER.size, shape=(int(n_valid),))
            except (OSError, ValueError) as e:
                raise SpillRecordError(
                    f"spill record {rec.path}: truncated payload (mmap of {nbytes} bytes failed: {e})"
                ) from e
            if (zlib.crc32(keys) & 0xFFFFFFFF) != crc:
                raise SpillRecordError(f"spill record {rec.path}: checksum mismatch (corrupt payload)")
    return SpillChunk(
        keys=keys, orig_dtype=orig_dt, device_slot=None if slot < 0 else int(slot),
        chunk_index=int(chunk_index), bucket=int(bucket),
    )


class SpillStore:
    """A directory of spill generations plus the per-pass streaming log.

    Make one to own the lifecycle (tee a sketch's one pass, read
    ``pass_log`` after a descent, reuse generation 0 across calls), or let
    ``kselect_streaming(_many)`` make and remove one (``spill="force"``, or
    ``"auto"`` with a one-shot source). As a context manager it closes
    (removes) the directory on exit."""

    def __init__(self, spill_dir: str | None = None):
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.root = tempfile.mkdtemp(prefix=SPILL_DIR_PREFIX, dir=spill_dir)
        self.generations: dict[int, SpillGeneration] = {}
        #: One dict per streamed pass of a spill descent: ``{"pass",
        #: "read", "keys_read", "bytes_read", "disk_bytes_read"[,
        #: "keys_written", "bytes_written", "disk_bytes_written"]}``, the
        #: JAX package's fields (``bytes_*`` are full-width key bytes;
        #: ``disk_bytes_*`` equal them in format v1).
        self.pass_log: list[dict] = []
        self._counter = 0
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        if self._closed:
            raise SpillError("spill store is closed")

    def new_generation(self) -> SpillWriter:
        """Open a writer for the next generation (``gen-NNNN``)."""
        self._check_open()
        idx = self._counter
        self._counter += 1
        return SpillWriter(self, idx, os.path.join(self.root, f"gen-{idx:04d}"))

    def _register(self, gen: SpillGeneration) -> None:
        self._check_open()
        self.generations[gen.index] = gen

    def latest_generation(self) -> SpillGeneration:
        """The newest committed generation: what a read of the store as a
        source (a descent, the certificate, ``refine``) streams from."""
        self._check_open()
        if not self.generations:
            raise SpillError(
                "spill store holds no committed generation; run a teeing pass first "
                "(streaming_kselect(..., spill=store) or RadixSketch.update_stream(..., spill=store))"
            )
        return self.generations[max(self.generations)]

    def drop_generation(self, gen: SpillGeneration) -> None:
        """Delete one generation's records."""
        gen.dropped = True
        self.generations.pop(gen.index, None)
        shutil.rmtree(gen.path, ignore_errors=True)

    def close(self) -> None:
        """Remove the whole store directory. Idempotent; every generation
        becomes unreadable."""
        if self._closed:
            return
        self._closed = True
        for gen in self.generations.values():
            gen.dropped = True
        self.generations.clear()
        shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "SpillStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "closed" if self._closed else f"{len(self.generations)} gens"
        return f"SpillStore({self.root!r}, {state})"
