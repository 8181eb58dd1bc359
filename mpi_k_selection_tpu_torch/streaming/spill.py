"""Survivor spill store, formats v1 and v2 (counterpart of
``mpi_k_selection_tpu/streaming/spill.py``).

Without a cache every pass of the streamed descent (streaming/chunked.py)
re-reads the whole source: a P-pass descent moves about P·N key bytes
over the host-to-card link when only pass 0 needs all N. The store
applies the reference CGM's discard step (``TODO-kth-problem-cgm.c``: the
L/E/G counts and the window rebase) to the stream:

- pass 0 tees each chunk's encoded keys to generation 0;
- every later pass reads the previous generation, filters each chunk to
  the surviving prefixes on the card (the sweep kernel's tee part,
  streaming/executor.py) and writes only the compacted survivors as the
  next generation;
- one-shot sources become valid: passes >= 1 never touch the source.

A generation is a directory of records, one a chunk, in the JAX package's
formats, byte for byte: a ``<8sIqqqq8s8sIQ`` header (magic, version,
record index, ``n_valid``, staging bucket, device slot, key and stream
dtype tags, CRC32, payload bytes), then the payload. Format v1 stores the
keys at full width (the CRC covers them). Format v2 (``pack_spill="auto"``)
stores a segment directory (a count, then one ``<BQII`` entry a segment:
resolved bits, prefix, keys, CRC32 of the segment's payload; the header's
CRC covers the directory) and, per ``(resolved, prefix)`` segment, only
the unresolved low ``total_bits - resolved`` bits of each key,
bit-packed big-endian within each value, each segment byte-aligned with
its last byte zero-padded. A survivor generation segments by the pass's
own filter union (each key under its deepest spec); the pass-0 and
sketch tees segment by each key's top :data:`GEN0_SEGMENT_BITS`, so a
later pass's filtered read seeks only to the surviving segments
(``filter_specs``, ancestor matching). A record that packing would not
shrink stays v1, so a generation's physical bytes (``nbytes``) never
exceed its logical ones (``logical_nbytes``). Each committed generation
hoists its records' directories into one in-memory index, so a pruned
read seeks straight to its segments. Any mismatch between a record and
its writer's metadata, a directory or a segment raises
:class:`~mpi_k_selection_tpu_torch.errors.SpillRecordError` before a key
reaches a histogram. The pooled decode (``iter_chunks(workers=)``) waits
on ROADMAP Queue 1 item 3a: one thread decodes here, timed in
:data:`HOST_TIMES`.

The pack writes the JAX package's bytes by cheaper means: each segment's
keys are grouped by a stable sort of a small segment index (NumPy's radix
sort), and a width that is a whole number of bytes takes each key's low
bytes big-endian instead of a bit expansion; the pass-0 and sketch tees
group and cut their chunks on the card (:func:`pack_digits`,
streaming/executor.py: ``DigitTeeConsumer``). The reader reconstructs
whole-byte widths from overlapping big-endian windows.

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
import torch

from mpi_k_selection_tpu_torch.errors import SpillError, SpillRecordError
from mpi_k_selection_tpu_torch.faults.inject import maybe_fault as _maybe_fault
from mpi_k_selection_tpu_torch.obs import ledger as _ledger
from mpi_k_selection_tpu_torch.streaming.pipeline import _bucket_elems
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype
from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

#: Directory prefix of every store (the JAX package's
#: ``resource_protocols.SPILL_DIR_PREFIX``, so the test suite's
#: leaked-directory check covers the port's stores).
SPILL_DIR_PREFIX = "ksel-spill-"

#: The ``spill=`` knob's string modes (a SpillStore is also accepted).
SPILL_MODES = ("auto", "off", "force")

#: The ``pack_spill`` knob's modes: ``"auto"`` writes format v2 wherever
#: packing shrinks a record (v1 otherwise), ``"off"`` format v1.
PACK_SPILL_MODES = ("auto", "off")

_MAGIC = b"KSPILL1\x00"
_VERSION = 1
_VERSION_PACKED = 2
# magic, version, record index, n_valid, bucket, device slot (-1: none),
# key dtype tag, stream dtype tag, crc32 (v1: the payload; v2: the segment
# directory), payload bytes
_HEADER = struct.Struct("<8sIqqqq8s8sIQ")
# v2 segment directory: a count, then (resolved bits, prefix, keys, crc32
# of the segment's payload) a segment; the payloads follow in directory
# order, each byte-aligned
_SEG_COUNT = struct.Struct("<q")
_SEG_ENTRY = struct.Struct("<BQII")
#: The top-digit width a pass-0 or sketch tee segments its records by
#: under ``pack_spill="auto"`` (the JAX package's).
GEN0_SEGMENT_BITS = 8
# values a slice of the bit-expanding pack (widths that are not whole
# bytes): a multiple of 8, so slices stay byte-aligned
_PACK_SLICE = 1 << 16
# NumPy's dtype tag of ml_dtypes' bfloat16 is a bare 2-byte void, which
# np.dtype() reads back as void: the one tag mapped back by name
_BFLOAT16_TAG = "<V2"

#: Host time of the record work, summed over threads: ``prepare`` (v1 CRC;
#: v2 grouping, pack and CRCs, the card's pack waited on included),
#: ``write`` (the record file) and ``read`` (file read, CRCs and the v2
#: decode). The descent snapshots them per pass into
#: ``SpillStore.pass_host_ms``.
HOST_TIMES = {"prepare": Stopwatch(), "write": Stopwatch(), "read": Stopwatch()}


def validate_pack_spill(pack_spill):
    """Normalize the ``pack_spill`` knob (None = the ``"off"`` default)."""
    if pack_spill is None:
        return "off"
    if pack_spill in PACK_SPILL_MODES:
        return pack_spill
    raise ValueError(f"pack_spill must be one of {PACK_SPILL_MODES}, got {pack_spill!r}")


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


# -- the pack -----------------------------------------------------------------


def _low_bytes(vals: np.ndarray, nbytes: int) -> np.ndarray:
    """The low ``nbytes`` bytes of each unsigned value, big-endian, back
    to back: the bit pack of a whole-byte width."""
    kb = vals.dtype.itemsize
    be = vals.astype(f">u{kb}").view(np.uint8).reshape(-1, kb)
    return be.reshape(-1) if nbytes == kb else np.ascontiguousarray(be[:, kb - nbytes:]).reshape(-1)


def _pack_low_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """The JAX package's bit pack: ``vals`` (unsigned, each below
    ``2**width``) big-endian within each value, back to back, the last
    byte zero-padded; ``ceil(len(vals) * width / 8)`` bytes."""
    n = int(vals.shape[0])
    if n == 0:
        return np.empty((0,), np.uint8)
    if width % 8 == 0 and width <= 8 * vals.dtype.itemsize:
        return _low_bytes(vals, width // 8)
    parts = []
    for lo in range(0, n, _PACK_SLICE):
        be = vals[lo:lo + _PACK_SLICE].astype(">u8").view(np.uint8).reshape(-1, 8)
        bits = np.unpackbits(be, axis=1)[:, 64 - width:]
        parts.append(np.packbits(bits.reshape(-1)))
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _padded(buf: np.ndarray, nbytes: int) -> np.ndarray:
    """``buf`` with at least 8 bytes after its first ``nbytes`` (a copy
    only when it has fewer): what the windowed decode reads past the last
    value."""
    if buf.shape[0] >= nbytes + 8:
        return buf
    out = np.zeros(nbytes + 8, np.uint8)
    out[:nbytes] = buf[:nbytes]
    return out


def _decode(buf: np.ndarray, count: int, resolved: int, prefix: int, key_dt: np.dtype) -> np.ndarray:
    """One v2 segment's keys: its ``count`` packed low bits (``buf``, the
    segment's bytes, possibly followed by others) under ``prefix``. A
    whole-byte width reads each value as an unaligned big-endian window
    of the key's width, shifted down; other widths unpack their bits."""
    kb = key_dt.itemsize
    width = kb * 8 - resolved
    if count == 0:
        return np.empty((0,), key_dt)
    if width % 8:
        keys = _unpack_low_bits(buf, count, width)
        if resolved:
            keys |= np.uint64(prefix << width)
        return keys.astype(key_dt)
    wb = width // 8
    buf = _padded(buf, count * wb)
    win = np.ndarray((count,), dtype=f">u{kb}", buffer=buf, strides=(wb,))
    keys = win.astype(key_dt)
    if wb < kb:
        keys >>= key_dt.type(8 * (kb - wb))
    if resolved:
        keys |= key_dt.type(prefix << width)
    return keys


def _unpack_low_bits(buf: np.ndarray, count: int, width: int) -> np.ndarray:
    """Exact inverse of :func:`_pack_low_bits`: ``buf`` (uint8) back to a
    uint64 array of ``count`` values."""
    if count == 0:
        return np.empty((0,), np.uint64)
    if width % 8 == 0:
        wb = width // 8
        win = np.ndarray((count,), dtype=">u8", buffer=_padded(buf, count * wb), strides=(wb,))
        out = win.astype(np.uint64)
        if wb < 8:
            out >>= np.uint64(64 - width)
        return out
    out = np.empty((count,), np.uint64)
    slice_bytes = _PACK_SLICE * width // 8
    for i, lo in enumerate(range(0, count, _PACK_SLICE)):
        cnt = min(_PACK_SLICE, count - lo)
        seg = np.ascontiguousarray(buf[i * slice_bytes:i * slice_bytes + (cnt * width + 7) // 8])
        bits = np.zeros((cnt, 64), np.uint8)
        bits[:, 64 - width:] = np.unpackbits(seg, count=cnt * width).reshape(cnt, width)
        out[lo:lo + cnt] = np.packbits(bits, axis=1).view(">u8").reshape(-1)
    return out


def _grouped_segments(u: np.ndarray, idx, specs, total_bits: int) -> list:
    """``(resolved, prefix, count, payload)`` of each spec of ``specs``
    (one depth), the keys ``u`` of each in stream order: ``idx`` (None for
    one spec) is each key's spec index, grouped by a stable sort."""
    r = specs[0][0]
    width = total_bits - r
    if idx is None:
        counts, su = [u.shape[0]], u
    else:
        counts = np.bincount(idx, minlength=len(specs))
        # the narrowest index dtype: NumPy's stable sort of 8- and 16-bit keys is a radix sort
        small = np.uint8 if len(specs) <= 1 << 8 else np.uint16 if len(specs) <= 1 << 16 else np.uint32
        su = u[np.argsort(idx.astype(small), kind="stable")]
    if width < 8 * su.dtype.itemsize:
        su = su & su.dtype.type((1 << width) - 1)
    segments = []
    if width % 8 == 0:
        flat = _low_bytes(su, width // 8)
        off = 0
        for (_, p), c in zip(specs, counts):
            nb = int(c) * width // 8
            segments.append((r, int(p), int(c), flat[off:off + nb]))
            off += nb
        return segments
    lo = 0
    for (_, p), c in zip(specs, counts):
        segments.append((r, int(p), int(c), _pack_low_bits(su[lo:lo + int(c)], width)))
        lo += int(c)
    return segments


def _unassigned(n_missing: int) -> SpillError:
    return SpillError(
        f"packed spill writer: {n_missing} keys match no (resolved, prefix) spec — the tee filter and the pack "
        "specs disagree (a bug in streaming/chunked.py, not in the stream)"
    )


def _pack_payload(keys: np.ndarray, specs, total_bits: int) -> list:
    """The segments of a v2 record of ``keys`` under the ``(resolved,
    prefix)`` union ``specs``, the JAX package's ``_pack_payload`` layout:
    specs in (deepest first, then prefix) order, every spec a segment
    (empty ones too), each key in the deepest spec it matches, in stream
    order within its segment. A key matching no spec raises SpillError."""
    ordered = sorted(((int(r), int(p)) for r, p in specs), key=lambda s: (-s[0], s[1]))
    u = np.ascontiguousarray(keys).reshape(-1)
    u = u.view(f"u{u.dtype.itemsize}")
    if 8 * u.dtype.itemsize != total_bits:
        u = u.astype(np.uint64)
    if len({r for r, _ in ordered}) == 1:
        r0 = ordered[0][0]
        if len(ordered) == 1:
            missing = int(np.count_nonzero((u >> u.dtype.type(total_bits - r0)) != u.dtype.type(ordered[0][1]))) if r0 else 0
            if missing:
                raise _unassigned(missing)
            return _grouped_segments(u, None, ordered, total_bits)
        tops = (u >> u.dtype.type(total_bits - r0)).astype(np.uint64)
        pref = np.asarray([p for _, p in ordered], np.uint64)
        idx = np.minimum(np.searchsorted(pref, tops), len(pref) - 1)
        missing = int(np.count_nonzero(pref[idx] != tops))
        if missing:
            raise _unassigned(missing)
        return _grouped_segments(u, idx, ordered, total_bits)
    u = u.astype(np.uint64, copy=False)
    assigned = np.zeros(u.shape[0], dtype=bool)
    segments = []
    for r, p in ordered:
        sel = ~assigned
        if r:
            sel &= (u >> np.uint64(total_bits - r)) == np.uint64(p)
        vals = u[sel]
        assigned |= sel
        width = total_bits - r
        if width < 64:
            vals &= np.uint64((1 << width) - 1)
        segments.append((r, p, int(vals.shape[0]), _pack_low_bits(vals, width)))
    if not bool(assigned.all()):
        raise _unassigned(int((~assigned).sum()))
    return segments


def _digit_segments(keys: np.ndarray, digit_bits: int) -> list:
    """The segments of a digit-segmented (pass-0 or sketch tee) record:
    one a top ``digit_bits`` digit present in ``keys``, ascending."""
    u = np.ascontiguousarray(keys).reshape(-1)
    u = u.view(f"u{u.dtype.itemsize}")
    total_bits = 8 * u.dtype.itemsize
    tops = (u >> u.dtype.type(total_bits - digit_bits)).astype(np.intp)
    present = np.flatnonzero(np.bincount(tops, minlength=1 << digit_bits))
    specs = [(digit_bits, int(t)) for t in present]
    if len(specs) == 1:
        return _grouped_segments(u, None, specs, total_bits)
    lut = np.zeros(1 << digit_bits, np.int64)
    lut[present] = np.arange(present.shape[0])
    return _grouped_segments(u, lut[tops], specs, total_bits)


def pack_digits(keys: torch.Tensor, digit_bits: int, total_bits: int):
    """The card's half of a digit-segmented record: ``keys`` (carrier keys
    of a chunk, the key in the low ``total_bits`` bits) grouped by their
    top ``digit_bits`` bits with a stable sort, and each key's low bytes
    below the digit, big-endian, back to back. Returns the int64 digit
    counts and the uint8 payload, on ``keys``' device, not waited on
    (``total_bits - digit_bits`` must be whole bytes)."""
    carrier = keys.element_size() * 8
    width = total_bits - digit_bits
    tops = _dt.shift_right_logical(keys, width, carrier)
    counts = torch.bincount(tops, minlength=1 << digit_bits)
    order = torch.sort(tops.to(torch.int16 if digit_bits < 16 else torch.int32), stable=True).indices
    sk = keys[order]
    cols = [((sk >> (8 * (width // 8 - 1 - j))) & 0xFF).to(torch.uint8) for j in range(width // 8)]
    return counts, torch.stack(cols, 1).reshape(-1)


def digit_segments_from(counts: np.ndarray, payload: np.ndarray, digit_bits: int, total_bits: int) -> list:
    """:func:`pack_digits`' outputs, on the host, as record segments."""
    wb = (total_bits - digit_bits) // 8
    segments, off = [], 0
    for t in np.flatnonzero(counts):
        c = int(counts[t])
        segments.append((digit_bits, int(t), c, payload[off:off + c * wb]))
        off += c * wb
    return segments


@dataclasses.dataclass(frozen=True)
class SpillRecord:
    """On-disk metadata of one spilled chunk: the ``(chunk_index, bucket,
    dtype, device)`` key plus the payload's size and checksum (the
    physical payload: the keys in v1; the directory and packed segments in
    v2, whose ``crc32`` covers the directory). The header on disk repeats
    all of it, and the reader cross-checks both. ``segments`` is a v2
    record's ``(resolved, prefix, count, payload crc32)`` layout."""

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
    segments: tuple | None = None

    @property
    def packed(self) -> bool:
        return self.version >= _VERSION_PACKED

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
    """The order-free half of one append: the payload built and
    checksummed (``parts``, written back to back), not yet given a record
    index or written (:meth:`SpillWriter.prepare`)."""

    n: int
    key_dtype: np.dtype
    orig_dtype: np.dtype
    version: int
    parts: tuple
    nbytes: int
    crc: int
    segments: tuple | None = None


def prepared_record(keys_fn, n: int, key_dtype, orig_dtype, segments=None) -> PreparedSpillRecord:
    """A record of ``n`` keys of ``key_dtype``: format v2 from
    ``segments`` (``(resolved, prefix, count, payload)``) when their
    directory and payloads undercut the full-width keys, else v1 of
    ``keys_fn()`` (the keys in stream order)."""
    key_dtype, orig_dtype = np.dtype(key_dtype), np.dtype(orig_dtype)
    if segments is not None:
        crcs = [zlib.crc32(pay) & 0xFFFFFFFF for *_, pay in segments]
        directory = _SEG_COUNT.pack(len(segments)) + b"".join(
            _SEG_ENTRY.pack(r, p, c, crc) for (r, p, c, _), crc in zip(segments, crcs))
        nbytes = len(directory) + sum(int(pay.nbytes) for *_, pay in segments)
        if nbytes < n * key_dtype.itemsize:
            return PreparedSpillRecord(
                n=n, key_dtype=key_dtype, orig_dtype=orig_dtype, version=_VERSION_PACKED,
                parts=(np.frombuffer(directory, np.uint8), *(pay for *_, pay in segments if pay.nbytes)),
                nbytes=nbytes, crc=zlib.crc32(directory) & 0xFFFFFFFF,
                segments=tuple((r, p, c, crc) for (r, p, c, _), crc in zip(segments, crcs)),
            )
    keys = np.ascontiguousarray(keys_fn()).reshape(-1)
    return PreparedSpillRecord(
        n=n, key_dtype=key_dtype, orig_dtype=orig_dtype, version=_VERSION, parts=(keys,), nbytes=int(keys.nbytes),
        crc=zlib.crc32(keys.data) & 0xFFFFFFFF,
    )


class SpillWriter:
    """Append-only writer of ONE generation, called from one thread per
    pass (the producer or the digit tee's consumer for the pass-0 tee, the
    consumer for the filtered survivor writes); ``commit`` or ``abort``
    runs after the pass.

    ``pack_specs`` (the pass's ``(resolved_bits, prefix)`` filter union)
    with ``total_bits`` writes every record in format v2 segmented by the
    union, where that shrinks it; ``pack_digit_bits`` does the same for an
    unfiltered tee (pass 0, a sketch's), segmented by each key's top
    ``pack_digit_bits`` bits (at most the key bits less one)."""

    def __init__(self, store: "SpillStore", index: int, path: str, pack_specs=None, total_bits: int | None = None,
                 pack_digit_bits: int | None = None):
        if pack_specs is not None and total_bits is None:  # pragma: no cover
            raise SpillError("pack_specs requires total_bits")
        if pack_specs is not None and pack_digit_bits:  # pragma: no cover
            raise SpillError("pack_specs and pack_digit_bits are exclusive")
        self.store = store
        self.index = index
        self.path = path
        self.pack_specs = None if pack_specs is None else tuple((int(r), int(p)) for r, p in pack_specs)
        self.total_bits = total_bits
        self.pack_digit_bits = int(pack_digit_bits) if pack_digit_bits else None
        os.makedirs(path)
        self._records: list[SpillRecord] = []
        self._count = 0
        self._done = False

    def digit_bits(self, total_bits: int) -> int | None:
        """The digit a digit-segmented record of ``total_bits``-bit keys
        takes, or None when the writer does not segment by digit."""
        return None if self.pack_digit_bits is None else min(self.pack_digit_bits, total_bits - 1)

    def prepare(self, keys: np.ndarray, orig_dtype) -> PreparedSpillRecord:
        """Ravel, pack (format v2 where the writer packs and it shrinks
        the record) and checksum one chunk's keys (no index, no disk)."""
        with HOST_TIMES["prepare"].timing():
            keys = np.ascontiguousarray(keys).reshape(-1)
            n = int(keys.shape[0])
            segments = None
            if n and self.pack_specs is not None:
                segments = _pack_payload(keys, self.pack_specs, self.total_bits)
            elif n and self.pack_digit_bits is not None:
                segments = _digit_segments(keys, self.digit_bits(8 * keys.dtype.itemsize))
            return prepared_record(lambda: keys, n, keys.dtype, orig_dtype, segments)

    def append_prepared(self, prep: PreparedSpillRecord, device_slot=None) -> SpillRecord:
        """Write one prepared record as the generation's next record.

        The ``"spill.write"`` fault site fires first, before anything
        touches disk, keyed by the record's index in the generation: the
        in-order write count, never the order records were prepared or
        packed in. A pass that runs again builds a fresh writer, whose
        count restarts, so record *i*'s next write advances the site's
        attempt counter."""
        if self._done:
            raise SpillError("spill generation already committed/aborted")
        _maybe_fault("spill.write", index=self._count)
        slot = -1 if device_slot is None else int(device_slot)
        rec_path = os.path.join(self.path, f"r{self._count:08d}.kspill")
        bucket = _bucket_elems(prep.n)
        header = _HEADER.pack(
            _MAGIC, prep.version, self._count, prep.n, bucket, slot, _pack_dtype(prep.key_dtype),
            _pack_dtype(prep.orig_dtype), prep.crc, prep.nbytes,
        )
        with HOST_TIMES["write"].timing(), open(rec_path, "wb") as f:
            f.write(header)
            for part in prep.parts:
                f.write(part.data)
        rec = SpillRecord(
            path=rec_path, chunk_index=self._count, n_valid=prep.n, bucket=bucket, device_slot=device_slot,
            key_dtype=prep.key_dtype, orig_dtype=prep.orig_dtype, crc32=prep.crc, nbytes=prep.nbytes,
            version=prep.version, segments=prep.segments,
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


def _segment_matches(r_seg: int, p_seg: int, specs) -> bool:
    """True when a ``(r_seg, p_seg)`` segment may hold keys under any
    ``(resolved, prefix)`` filter spec: a deeper spec matches when the
    segment's prefix is its ancestor, a shallower one when the segment
    lies under it."""
    for r_f, p_f in specs:
        if r_f >= r_seg:
            if p_f >> (r_f - r_seg) == p_seg:
                return True
        elif p_seg >> (r_seg - r_f) == p_f:
            return True
    return False


def _seg_index(rec: SpillRecord):
    """A v2 record's ``(resolved, prefix, count, crc, offset, nbytes)``
    segments, offsets from the payload's start, or None (v1, or a record
    made without its layout)."""
    if rec.segments is None or any(len(s) != 4 for s in rec.segments):
        return None
    bits = rec.key_dtype.itemsize * 8
    off = _SEG_COUNT.size + len(rec.segments) * _SEG_ENTRY.size
    entries = []
    for r, p, c, crc in rec.segments:
        nb = (c * (bits - r) + 7) // 8
        entries.append((r, p, c, crc, off, nb))
        off += nb
    return tuple(entries)


class SpillGeneration:
    """One committed generation: an ordered, replayable set of records.
    ``as_source()`` is a chunk source for every streaming entry point;
    each read re-validates the records. The records' v2 directories are
    hoisted into one index at commit, so a pruned read seeks straight to
    its segments."""

    def __init__(self, store, index: int, path: str, records: tuple):
        self.store = store
        self.index = index
        self.path = path
        self.records = records
        self.dropped = False
        self._seg_index = {rec.chunk_index: e for rec in records if (e := _seg_index(rec)) is not None}

    @property
    def nbytes(self) -> int:
        """Payload bytes on disk (the packed size of v2 records)."""
        return sum(r.nbytes for r in self.records)

    @property
    def logical_nbytes(self) -> int:
        """Full-width key bytes a read streams into its consumers (equal to
        :attr:`nbytes` when no record is packed)."""
        return sum(r.logical_nbytes for r in self.records)

    @property
    def packed(self) -> bool:
        """True when any record is format v2."""
        return any(r.packed for r in self.records)

    @property
    def keys(self) -> int:
        return sum(r.n_valid for r in self.records)

    def iter_chunks(self, mmap: bool = False, filter_specs=None):
        """Yield every record as a :class:`SpillChunk`, validating headers,
        sizes and checksums (a mismatch raises SpillRecordError). ``mmap``
        serves a v1 payload as a read-only ``np.memmap`` view (checksummed
        in place) instead of a heap copy. ``filter_specs`` (a
        ``(resolved_bits, prefix)`` union) prunes v2 records to the
        segments that may hold matching keys (a superset of them: the
        consumers' own filters select the keys); v1 records are read
        whole, and records left with no key are skipped."""
        if self.dropped:
            raise SpillError(
                f"spill generation {self.index} was dropped (or its store closed); "
                "it can no longer serve as a chunk source"
            )
        for rec in self.records:
            chunk = _read_record(rec, mmap=mmap, filter_specs=filter_specs,
                                 seg_index=self._seg_index.get(rec.chunk_index))
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
        every v1 record whole; of a v2 record the segments matching
        ``filter_specs``, plus its directory where the generation's index
        does not cover it."""
        if filter_specs is None:
            return self.nbytes
        specs = tuple((int(r), int(p)) for r, p in filter_specs)
        total = 0
        for rec in self.records:
            if rec.segments is None:
                total += rec.nbytes
                continue
            bits = rec.key_dtype.itemsize * 8
            if rec.chunk_index not in self._seg_index:
                total += _SEG_COUNT.size + len(rec.segments) * _SEG_ENTRY.size
            total += sum((c * (bits - r) + 7) // 8 for r, p, c, *_ in rec.segments if _segment_matches(r, p, specs))
        return total

    def read_keys(self, filter_specs=None) -> int:
        """Keys a (filtered) read streams into its consumers."""
        if filter_specs is None:
            return self.keys
        specs = tuple((int(r), int(p)) for r, p in filter_specs)
        return sum(
            rec.n_valid if rec.segments is None
            else sum(c for r, p, c, *_ in rec.segments if _segment_matches(r, p, specs))
            for rec in self.records
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpillGeneration(index={self.index}, records={len(self.records)}, keys={self.keys}, nbytes={self.nbytes})"


def _checked(buf: np.ndarray, crc: int, path: str, r: int, p: int) -> None:
    if (zlib.crc32(buf) & 0xFFFFFFFF) != crc:
        raise SpillRecordError(f"spill record {path}: checksum mismatch (corrupt segment resolved={r} prefix={p:#x})")


def _read_packed(read_at, nbytes: int, n_valid: int, key_dt: np.dtype, dir_crc: int, path: str,
                 filter_specs=None, seg_index=None) -> np.ndarray:
    """A v2 record's keys: ``read_at(offset, size)`` serves payload bytes
    as a uint8 array with at least 8 more bytes after them (zeros past the
    payload). With the generation's ``seg_index`` a filtered read seeks
    straight to the matching segments; otherwise the directory is read and
    checked first (its CRC is the header's). Every segment read is
    checksummed before it is decoded."""
    total_bits = key_dt.itemsize * 8
    if seg_index is not None and filter_specs is not None:
        entries = [(r, p, c, crc, off) for r, p, c, crc, off, _ in seg_index]
    else:
        if nbytes < _SEG_COUNT.size:
            raise SpillRecordError(f"spill record {path}: truncated segment directory")
        (nseg,) = _SEG_COUNT.unpack(read_at(0, _SEG_COUNT.size)[:_SEG_COUNT.size].tobytes())
        dirlen = _SEG_COUNT.size + nseg * _SEG_ENTRY.size
        if nseg < 0 or dirlen > nbytes:
            raise SpillRecordError(f"spill record {path}: segment directory of {nseg} entries does not fit the payload")
        raw = read_at(0, dirlen)[:dirlen].tobytes()
        if (zlib.crc32(raw) & 0xFFFFFFFF) != dir_crc:
            raise SpillRecordError(f"spill record {path}: checksum mismatch (corrupt segment directory)")
        entries, off = [], dirlen
        for i in range(nseg):
            r, p, c, crc = _SEG_ENTRY.unpack_from(raw, _SEG_COUNT.size + i * _SEG_ENTRY.size)
            if not 0 <= r < total_bits or (p >> r if r else p):
                raise SpillRecordError(
                    f"spill record {path}: bad segment (resolved={r}, prefix={p:#x}, count={c}) for "
                    f"{total_bits}-bit keys"
                )
            entries.append((r, p, c, crc, off))
            off += (c * (total_bits - r) + 7) // 8
        if sum(e[2] for e in entries) != n_valid:
            raise SpillRecordError(
                f"spill record {path}: segment counts sum to {sum(e[2] for e in entries)}, header says {n_valid} keys"
            )
        if off != nbytes:
            raise SpillRecordError(f"spill record {path}: packed payload is {nbytes} bytes, segment directory implies {off}")
    parts = []
    for r, p, c, crc, off in entries:
        if not c or (filter_specs is not None and not _segment_matches(r, p, filter_specs)):
            continue
        nb = (c * (total_bits - r) + 7) // 8
        buf = read_at(off, nb)
        _checked(buf[:nb], crc, path, r, p)
        parts.append(_decode(buf, c, r, p, key_dt))
    if not parts:
        return np.empty((0,), key_dt)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _read_record(rec: SpillRecord, mmap: bool = False, filter_specs=None, seg_index=None) -> SpillChunk:
    # the "spill.read" fault site, keyed by the record's chunk index, before
    # the open: a transient kind raises here, a persistent one damages the
    # file and falls through, so the real header, size and CRC checks below
    # are what the recovery ladder (streaming/chunked.py) meets
    _maybe_fault("spill.read", index=rec.chunk_index, path=rec.path)
    with HOST_TIMES["read"].timing():
        return _read_record_untimed(rec, mmap, filter_specs, seg_index)


def _read_record_untimed(rec: SpillRecord, mmap: bool, filter_specs, seg_index) -> SpillChunk:
    try:
        f = open(rec.path, "rb")
    except OSError as e:
        raise SpillRecordError(f"spill record {rec.path}: unreadable ({e})") from e
    with f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise SpillRecordError(f"spill record {rec.path}: truncated header ({len(head)} of {_HEADER.size} bytes)")
        magic, version, chunk_index, n_valid, bucket, slot, key_raw, orig_raw, crc, nbytes = _HEADER.unpack(head)
        if magic != _MAGIC or version not in (_VERSION, _VERSION_PACKED):
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
        if version == _VERSION and nbytes != n_valid * key_dt.itemsize:
            raise SpillRecordError(
                f"spill record {rec.path}: payload size {nbytes} != {n_valid} x {key_dt.itemsize}-byte keys"
            )
        if version == _VERSION_PACKED and not mmap:
            def file_at(off, size):
                # seeks: a pruned read touches only its segments
                f.seek(_HEADER.size + off)
                buf = np.zeros(size + 8, np.uint8)
                got = f.readinto(memoryview(buf)[:size])
                if got != size:
                    raise SpillRecordError(
                        f"spill record {rec.path}: truncated payload ({got} of {size} bytes at offset {off})"
                    )
                return buf

            keys = _read_packed(file_at, nbytes, n_valid, key_dt, crc, rec.path, filter_specs, seg_index)
        elif not mmap:
            payload = bytearray(nbytes)  # writable: the keys become a tensor without a copy
            got = f.readinto(payload)
            if got != nbytes:
                raise SpillRecordError(f"spill record {rec.path}: truncated payload ({got} of {nbytes} bytes)")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise SpillRecordError(f"spill record {rec.path}: checksum mismatch (corrupt payload)")
            keys = np.frombuffer(payload, dtype=key_dt)
    if mmap:
        keys = _read_mapped(rec.path, version, n_valid, nbytes, key_dt, crc, filter_specs, seg_index)
    return SpillChunk(
        keys=keys, orig_dtype=orig_dt, device_slot=None if slot < 0 else int(slot),
        chunk_index=int(chunk_index), bucket=int(bucket),
    )


def _read_mapped(path, version, n_valid, nbytes, key_dt, crc, filter_specs, seg_index) -> np.ndarray:
    """The mmap route: a v1 payload is served as the page-cache view
    itself; a v2 record decodes from its mapped segments onto the heap."""
    if n_valid == 0:  # pragma: no cover - writers skip empty chunks
        return np.empty((0,), key_dt)
    packed = version == _VERSION_PACKED
    try:
        raw = np.memmap(path, dtype=np.uint8 if packed else key_dt, mode="r", offset=_HEADER.size,
                        shape=(int(nbytes if packed else n_valid),))
    except (OSError, ValueError) as e:
        raise SpillRecordError(f"spill record {path}: truncated payload (mmap of {nbytes} bytes failed: {e})") from e
    if not packed:
        if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
            raise SpillRecordError(f"spill record {path}: checksum mismatch (corrupt payload)")
        return raw

    def mem_at(off, size):
        return _padded(raw[off:off + size], size)

    return _read_packed(mem_at, nbytes, n_valid, key_dt, crc, path, filter_specs, seg_index)


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
        #: JAX package's fields (``bytes_*`` are full-width key bytes,
        #: ``disk_bytes_*`` the physical ones: smaller for v2 records).
        self.pass_log: list[dict] = []
        #: Beside each ``pass_log`` entry, the pass's host milliseconds in
        #: the record work of :data:`HOST_TIMES` (``{"pass", "prepare_ms",
        #: "write_ms", "read_ms"}``): the port's own, not the JAX package's.
        self.pass_host_ms: list[dict] = []
        self._counter = 0
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        if self._closed:
            raise SpillError("spill store is closed")

    def new_generation(self, pack_specs=None, total_bits=None, pack_digit_bits=None) -> SpillWriter:
        """Open a writer for the next generation (``gen-NNNN``):
        ``pack_specs`` with ``total_bits``, or ``pack_digit_bits``, write
        format v2 (:class:`SpillWriter`); neither, format v1."""
        self._check_open()
        idx = self._counter
        self._counter += 1
        return SpillWriter(self, idx, os.path.join(self.root, f"gen-{idx:04d}"), pack_specs=pack_specs,
                           total_bits=total_bits, pack_digit_bits=pack_digit_bits)

    def _register(self, gen: SpillGeneration) -> None:
        self._check_open()
        self.generations[gen.index] = gen
        # the ledger's byte book (obs/ledger.py): a committed generation
        # adds its bytes on disk, its drop or the store's close subtracts them
        _ledger.LEDGER.adjust_bytes("spill", "disk", gen.nbytes)

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
        if self.generations.pop(gen.index, None) is not None:  # a second drop subtracts nothing
            _ledger.LEDGER.adjust_bytes("spill", "disk", -gen.nbytes)
        shutil.rmtree(gen.path, ignore_errors=True)

    def close(self) -> None:
        """Remove the whole store directory. Idempotent; every generation
        becomes unreadable."""
        if self._closed:
            return
        self._closed = True
        for gen in self.generations.values():
            gen.dropped = True
            _ledger.LEDGER.adjust_bytes("spill", "disk", -gen.nbytes)
        self.generations.clear()
        shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "SpillStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "closed" if self._closed else f"{len(self.generations)} gens"
        return f"SpillStore({self.root!r}, {state})"
