"""The streamed descent's per-chunk ingest kernel: wrapper, plain version
and counters.

Counterpart of ``mpi_k_selection_tpu/ops/pallas/sweep_ingest.py``
(``sweep_ingest_core``, 32-bit key spaces) and of the XLA fusion tier
``ops/pallas/fused_ingest.py`` that the JAX package runs for the other key
spaces. :func:`sweep_ingest` computes, from ONE read of a staged bucket of
raw words, every part a streamed pass enables, as the tuple
``(hist, collect, tee, cert, sketch)``:

- ``hist``: ``(K, 2^radix_bits)`` int32 counts of the digit at ``shift``
  under each of the K ``hist_prefixes`` (the bits above the digit equal
  the prefix), over the WHOLE bucket: pads count as key 0 and the caller
  subtracts them; None without prefixes.
- ``collect``: one ``(buffer, count)`` pair per ``(shift, prefix)`` spec:
  the valid keys with ``key >> shift == prefix`` front-packed in chunk
  order into a bucket-length buffer, zeros after (``compact_core``'s
  buffer, byte for byte), and their int32 count.
- ``tee``: the same pair over the union of the ``tee`` specs; None without.
- ``cert``: the int32 pair ``(#keys < vkey, #keys <= vkey)`` over the valid
  keys, in unsigned key order; None without ``vkey``.
- ``sketch``: ``(int32 counts of the top sketch_bits key bits over the
  whole bucket, key min, key max)``, the extremes over the valid keys as
  0-d tensors of the words' dtype; None without ``sketch_bits``.

The bucket ``data`` is a contiguous 1-D tensor of a 4- or 8-byte dtype
holding raw words: its first ``n_valid`` are keyed under ``key_op`` /
``key_xor`` as the histogram kernels key them
(ops/cuda/histogram.py), and the rest are pads that count as key 0
whatever their bits. Keys, prefixes and ``vkey`` are unsigned key values
(Python ints); collect buffers hold keys in the words' signed view.

A CUDA tensor launches ``csrc/sweep_ingest.cu`` or raises; a CPU tensor
takes :func:`sweep_ingest_plain`. ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` the plain version's calls. :func:`sweep_plan` lays out a
launch: its route (order-free without survivor buffers, ordered with
them), tiles, grid and shared memory (int32 counters, or 16-bit ones for
a 15- or 16-bit sketch or histogram of one prefix). One launch serves a bucket, unless
it holds more than ``MAX_TABLE_PREFIXES`` distinct histogram prefixes.
The outputs are views of one zeroed arena of counters, and each survivor
buffer is written whole by the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mpi_k_selection_tpu_torch.ops.cuda.histogram import KEY_OPS, resolve_hist_method
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

MAX_BITS = 20  # the widest histogram, a digit or the sketch: 2^20 int32 counters

LAUNCHES = {"sweep_ingest32": 0, "sweep_ingest64": 0}
PLAIN_CALLS = {"sweep_ingest": 0}

# The kernel's geometry (csrc/sweep_ingest.cu mirrors each number). The
# order-free route (no survivor buffer) streams with THREADS-thread blocks
# and UNROLL 16-byte loads in flight per thread, or, with 16-bit counters,
# WIDE_THREADS-thread blocks, one an SM; the ordered route takes
# TILE_BYTES tiles by ticket into STAGES shared-memory stages, with
# ORD_THREADS-thread blocks and a ROW_BYTES staging row per warp.
ORDER_FREE, ORDERED = "order-free", "ordered"
THREADS, UNROLL, WIDE_THREADS = 256, 4, 1024
ORD_THREADS, TILE_BYTES, STAGES, ROW_BYTES = 512, 64 * 1024, 3, 512
# Parameters travel by value up to PARAM_PREFIXES distinct prefixes and
# PARAM_SPECS specs, in device arrays above. The prefix table holds up to
# 2^TABLE_BITS entries, at most half used: more distinct prefixes than
# MAX_TABLE_PREFIXES take more launches (histograms only).
PARAM_PREFIXES, PARAM_SPECS = 64, 16
TABLE_BITS = 12
MAX_TABLE_PREFIXES = 1 << (TABLE_BITS - 1)
# Shared memory: an H100 SM's 228 KB (1 KB reserved per block) and a
# block's 227 KB, less 1 KB for the kernel's static variables; one
# histogram copy or the sketch counters in shared memory as int32 up to
# HIST_SMEM; sub-histogram copies up to COPIES_SMEM, an eighth of the SM's
# (the rest is L1, which holds the loads in flight). Wider counters, at
# PACKED_BITS (the sketch, or a histogram of one prefix), are 16-bit
# halves of 32-bit words in the wide order-free block: 128 KB at 16 bits.
SMEM_PER_SM, SMEM_RESERVED, SMEM_PER_BLOCK = 228 * 1024, 1024, 226 * 1024
MAX_THREADS_PER_SM = 2048
HIST_SMEM = 64 * 1024
COPIES_SMEM = SMEM_PER_SM // 8
PACKED_BITS = (15, 16)

_SMS: dict[int, int] = {}  # SM count per CUDA device index


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for name in d:
            d[name] = 0


def _check(data, n_valid, key_op, shift, radix_bits, hist_prefixes, collect, tee, sketch_bits):
    """The words' signed view, after checking every argument."""
    if data.dim() != 1 or not data.is_contiguous() or data.element_size() not in (4, 8):
        raise ValueError(
            f"data must be a contiguous 1-D tensor of a 4- or 8-byte dtype, got "
            f"{data.dtype} of shape {tuple(data.shape)}"
        )
    w = data.view(torch.int32 if data.element_size() == 4 else torch.int64)
    bits = w.element_size() * 8
    if key_op not in KEY_OPS:
        raise ValueError(f"unknown key_op {key_op!r}; choose from {KEY_OPS}")
    if not 0 <= n_valid <= w.numel():
        raise ValueError(f"n_valid={n_valid} outside the bucket of {w.numel()} words")
    if w.numel() >= 1 << 31:
        raise ValueError("a bucket holds fewer than 2^31 words (int32 counts)")
    if hist_prefixes is not None and (
        not 1 <= radix_bits <= MAX_BITS or shift < 0 or shift + radix_bits > bits
    ):
        raise ValueError(f"digit at shift={shift}, radix_bits={radix_bits} outside a {bits}-bit key")
    for s, p in (*collect, *tee):
        if not 0 <= s <= bits or not 0 <= p < 1 << bits:
            raise ValueError(f"spec (shift={s}, prefix={p}) outside a {bits}-bit key")
    if not 0 <= sketch_bits <= MAX_BITS:
        raise ValueError(f"sketch_bits={sketch_bits} outside [0, {MAX_BITS}]")
    return w


def _on_device(values, w):
    """Unsigned key values as a tensor of the words' signed view on the
    words' CUDA device, copied from pinned memory without a host wait (a
    pageable copy would wait for the stream, which waits for the chunk's
    own copy to the card): the prefixes or specs past what a launch takes
    by value."""
    bits = w.element_size() * 8
    host = torch.tensor([_dt.signed_const(int(v), bits) for v in values], dtype=w.dtype).pin_memory()
    return host.to(w.device, non_blocking=True)


def _spec_match(key, shift, prefix, bits):
    return _dt.shift_right_logical(key, shift, bits) == _dt.signed_const(prefix, bits)


def _compact(key, mask):
    """``compact_core``: the keys under ``mask`` scattered to the front of
    a bucket-length buffer by their running count, zeros after, and the
    int32 count."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask, pos, key.numel())  # non-survivors land past the end
    out = torch.zeros(key.numel() + 1, dtype=key.dtype, device=key.device)
    out.scatter_(0, tgt, key)
    return out[:-1], mask.sum(dtype=torch.int32)


def sweep_ingest_plain(data, n_valid, *, key_op="none", key_xor=0, shift=0, radix_bits=1,
                       hist_prefixes=None, collect=(), tee=(), vkey=None, sketch_bits=0):
    """Plain PyTorch version of :func:`sweep_ingest` (same contract)."""
    w = _check(data, n_valid, key_op, shift, radix_bits, hist_prefixes, collect, tee, sketch_bits)
    bits = w.element_size() * 8
    valid = torch.arange(w.numel(), device=w.device) < n_valid
    key = torch.where(valid, _dt.keys_from_raw(w, key_op, key_xor), 0)  # pads: key 0
    hist = None
    if hist_prefixes is not None:
        nb = 1 << radix_bits
        s = _dt.shift_right_logical(key, shift, bits)
        rows = []
        for p in hist_prefixes:
            z = s ^ _dt.signed_const(int(p) << radix_bits, bits)
            digit = torch.where((z >= 0) & (z < nb), z, nb)  # unsigned z < nb
            rows.append(torch.bincount(digit, minlength=nb + 1)[:nb])
        hist = torch.stack(rows).to(torch.int32) if rows else torch.zeros((0, nb), dtype=torch.int32)
    collect_out = tuple(_compact(key, _spec_match(key, s, p, bits) & valid) for s, p in collect)
    tee_out = None
    if tee:
        union = torch.zeros_like(valid)
        for s, p in tee:
            union |= _spec_match(key, s, p, bits)
        tee_out = _compact(key, union & valid)
    cert = None
    if vkey is not None:
        kb = _dt.order_bias(key, bits)
        vb = _dt.order_bias(torch.tensor(_dt.signed_const(vkey, bits), dtype=w.dtype), bits)
        cert = ((kb < vb) & valid).sum(dtype=torch.int32), ((kb <= vb) & valid).sum(dtype=torch.int32)
    sketch = None
    if sketch_bits:
        deep = torch.bincount(_dt.shift_right_logical(key, bits - sketch_bits, bits), minlength=1 << sketch_bits)
        kb = _dt.order_bias(key, bits)
        lo, hi = torch.iinfo(w.dtype).min, torch.iinfo(w.dtype).max
        kmin = _dt.order_bias(torch.where(valid, kb, hi).min(), bits)  # identities: all ones, 0
        kmax = _dt.order_bias(torch.where(valid, kb, lo).max(), bits)
        sketch = (deep.to(torch.int32), kmin, kmax)
    return hist, collect_out, tee_out, cert, sketch


class SweepPlan(NamedTuple):
    """One launch of the sweep kernel, as :func:`sweep_plan` lays it out
    (``csrc/sweep_ingest.cu``, ``launch`` and ``layout``)."""

    route: str  # ORDER_FREE or ORDERED
    threads: int
    tile_words: int  # words per ticket (ordered route), else 0
    n_tiles: int
    tbits: int  # prefix table bits (more than one prefix), else 0
    copies: int  # sub-histogram copies
    hist_smem: int  # bytes of a histogram counter in shared memory: 4, 2 (16-bit halves) or 0 (global)
    deep_smem: int  # the same for the sketch's counters
    smem: int  # dynamic shared memory of one block, bytes
    per_sm: int  # blocks an SM holds, by threads and shared memory
    blocks: int  # the grid asked for: at most per_sm per SM, at most the work
    prefixes_by_value: bool  # else the prefixes travel in a device array
    specs_by_value: bool  # else the specs travel in a device array


def _smem_bytes(route, bits, nd, tbits, copies, radix_bits, hist_smem, n_specs, sketch_bits, deep_smem) -> int:
    """Dynamic shared memory of one block (``csrc/sweep_ingest.cu:layout``):
    the tile stages, the warps' row staging and the specs (ordered route),
    the prefix table and the prefixes (more than one prefix), the
    sub-histogram copies and the sketch counters (``hist_smem`` and
    ``deep_smem`` bytes a counter), each 16-byte aligned."""
    def a16(b):
        return -(-b // 16) * 16

    wb = bits // 8
    total = 0
    if route == ORDERED:
        total += STAGES * TILE_BYTES + (ORD_THREADS // 32) * ROW_BYTES + a16(2 * n_specs * wb)
    if nd > 1:
        total += a16(2 << tbits) + a16(nd * wb)
    return total + copies * nd * (hist_smem << radix_bits) + (deep_smem << sketch_bits)


def sweep_plan(bits: int, n: int, *, nd: int, shift: int = 0, radix_bits: int = 1, n_collect: int = 0,
               n_tee: int = 0, sketch_bits: int = 0, sms: int) -> SweepPlan:
    """The launch of the sweep kernel over an ``n``-word bucket of
    ``bits``-wide words with ``nd`` distinct histogram prefixes (at most
    ``MAX_TABLE_PREFIXES``), ``n_collect`` collect and ``n_tee`` tee specs
    and a sketch of ``sketch_bits``, on a card of ``sms`` SMs.

    The route: ordered when any survivor buffer is asked for, else
    order-free. Shared memory, in order of need within the block's 227 KB:
    the fixed parts of the route; the histogram's int32 counters when one
    copy fits ``HIST_SMEM``, in the most of 8, 4, 2 copies within
    ``COPIES_SMEM`` (the rest of an SM's shared memory is L1, which holds
    the loads in flight), else one; the sketch's int32 counters when they
    fit ``HIST_SMEM`` and the block (an order-free 1-bit sketch, the
    extremes' launch of sub-32-bit keys, counts in registers). On the order-free route, a histogram
    of one prefix or a sketch at ``PACKED_BITS`` that has no room as int32
    takes 16-bit counters when they fit the block, in a block of
    ``WIDE_THREADS`` threads, one an SM (its launch bounds). Counters that
    do not fit go to global memory. The grid: every block resident at
    once (the kernel clamps it further by the occupancy of its registers),
    and no more blocks than work."""
    if not 0 <= nd <= MAX_TABLE_PREFIXES:
        raise ValueError(f"{nd} distinct prefixes in one launch; at most {MAX_TABLE_PREFIXES}")
    n_specs = n_collect + n_tee
    route = ORDERED if n_specs else ORDER_FREE
    tile_words = TILE_BYTES // (bits // 8) if route == ORDERED else 0
    n_tiles = -(-n // tile_words) if tile_words else 0
    pbits = bits - shift - radix_bits
    tbits = min(pbits, TABLE_BITS) if nd > 1 else 0

    def smem(copies, hist_smem, deep_smem):
        return _smem_bytes(route, bits, nd, tbits, copies, radix_bits, hist_smem, n_specs, sketch_bits, deep_smem)

    def packed(width, others):  # 16-bit counters at this width, if they fit beside the others
        return route == ORDER_FREE and width in PACKED_BITS and smem(*others) <= SMEM_PER_BLOCK

    copy = nd * (4 << radix_bits)
    hist_smem = 4 if 0 < copy <= HIST_SMEM and smem(1, 4, 0) <= SMEM_PER_BLOCK else 0
    if not hist_smem and nd == 1 and packed(radix_bits, (1, 2, 0)):
        hist_smem = 2
    copies = 1
    if hist_smem == 4:
        fits = [c for c in (8, 4, 2) if c * copy <= COPIES_SMEM and smem(c, 4, 0) <= SMEM_PER_BLOCK]
        copies = (fits + [1])[0]
    deep_smem = 0
    in_registers = sketch_bits == 1 and route == ORDER_FREE
    if sketch_bits and not in_registers and 4 << sketch_bits <= HIST_SMEM and smem(copies, hist_smem, 4) <= SMEM_PER_BLOCK:
        deep_smem = 4
    elif sketch_bits and packed(sketch_bits, (copies, hist_smem, 2)):
        deep_smem = 2
    nbytes = smem(copies, hist_smem, deep_smem)
    wide = 2 in (hist_smem, deep_smem)
    threads = ORD_THREADS if route == ORDERED else WIDE_THREADS if wide else THREADS
    per_sm = 1 if wide else max(1, min(MAX_THREADS_PER_SM // threads, SMEM_PER_SM // (nbytes + SMEM_RESERVED)))
    work = n_tiles if route == ORDERED else -(-n // (threads * UNROLL * 16 // (bits // 8)))
    return SweepPlan(
        route=route, threads=threads, tile_words=tile_words, n_tiles=n_tiles, tbits=tbits, copies=copies,
        hist_smem=hist_smem, deep_smem=deep_smem, smem=nbytes, per_sm=per_sm,
        blocks=max(1, min(per_sm * sms, work)), prefixes_by_value=nd <= PARAM_PREFIXES,
        specs_by_value=n_specs <= PARAM_SPECS,
    )


def distinct_prefixes(bits: int, shift: int, radix_bits: int, prefixes) -> tuple[list[int], list[int]]:
    """(the distinct prefixes a key can hold, in first-seen order; the row
    of each query). A query's prefix is ``p mod 2^(bits - radix_bits)``
    (the plain version's ``(p << radix_bits)`` in a ``bits``-wide word);
    one no key can hold (at least ``2^(bits - shift - radix_bits)``) takes
    row ``len(distinct)``, which stays zero."""
    pbits = bits - shift - radix_bits
    rows, distinct, out = {}, [], []
    for p in prefixes:
        pe = int(p) & ((1 << (bits - radix_bits)) - 1)
        if pe >> pbits:
            out.append(-1)
            continue
        if pe not in rows:
            rows[pe] = len(distinct)
            distinct.append(pe)
        out.append(rows[pe])
    return distinct, [len(distinct) if r < 0 else r for r in out]


def spec_masks(bits: int, specs) -> tuple[list[int], list[int]]:
    """(masks, wants) with ``key & mask == want`` exactly when ``key >>
    shift == prefix`` for each ``(shift, prefix)`` spec: a shift of the word
    width keeps no bits (JAX's logical shift gives 0 there), and a prefix
    wider than the bits left never matches (mask 0, want 1)."""
    full = (1 << bits) - 1
    masks, wants = [], []
    for s, p in specs:
        if p >> (bits - s):
            masks.append(0)
            wants.append(1)
        else:
            masks.append((full << s) & full)
            wants.append((p << s) & full)
    return masks, wants


def _lib():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    lib = build.load("sweep_ingest")
    if not getattr(lib, "_ksel_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for bits, xt in ((32, ctypes.c_uint32), (64, ctypes.c_uint64)):
            f = getattr(lib, f"ksel_sweep_ingest{bits}")
            f.argtypes = [
                p, ll, ll, i, xt,  # data, L, n_valid, is_float, key_xor
                i, p, p, i, i, i, i, i, i,  # nd, prefixes (host, device), shift, rb, pbits, tbits, copies, hist_smem
                i, i, p, p,  # nc, nt, specs (host, device)
                i, xt, i, i,  # cert, vkey, sketch_bits, deep_smem
                p, p, p, p, p, p, p, p, p,  # hist, counts, cert, deep, ext, done, ticket, status, surv
                p, ll, i, i, p,  # arena, its bytes (cleared by the launch), blocks, sms, stream
            ]
            f.restype = i
        lib.ksel_sweep_error_string.argtypes = [i]
        lib.ksel_sweep_error_string.restype = ctypes.c_char_p
        lib._ksel_typed = True
    return lib


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _host_words(values, bits):
    """``values`` as a ctypes array of unsigned words (read by the launch
    on the host, then passed to the kernel by value)."""
    ct = ctypes.c_uint32 if bits == 32 else ctypes.c_uint64
    return (ct * max(1, len(values)))(*values)


class _Layout(NamedTuple):
    """Everything of a launch that depends on its arguments' values only:
    the histogram's launch groups and rows, the specs, the plans and the
    arena's offsets (int32 words)."""

    groups: tuple  # (distinct prefixes, their host array, plan) per launch
    rows: tuple  # each query's row (``nd``: the zero row)
    identity: bool  # rows == 0 .. nq - 1
    specs: object  # masks then wants, a host array
    spec_words: tuple
    n_surv: int
    hist_words: int
    off_counts: int
    off_cert: int
    off_done: int
    off_deep: int
    off_ext: int
    off_status: int
    total: int


@functools.lru_cache(maxsize=256)
def _layout(bits, n, shift, radix_bits, prefixes, collect, tee, sketch_bits, sms) -> _Layout:
    distinct, rows = distinct_prefixes(bits, shift, radix_bits, prefixes or ())
    nd = len(distinct)
    nb = 1 << radix_bits
    nc, nt = len(collect), len(tee)
    n_surv = nc + (1 if tee else 0)
    groups = []
    for g0 in range(0, max(nd, 1), MAX_TABLE_PREFIXES):
        group = distinct[g0:g0 + MAX_TABLE_PREFIXES]
        first = g0 == 0
        plan = sweep_plan(bits, n, nd=len(group), shift=shift, radix_bits=radix_bits, n_collect=nc if first else 0,
                          n_tee=nt if first else 0, sketch_bits=sketch_bits if first else 0, sms=sms)
        groups.append((tuple(group), _host_words(group, bits), plan))
    masks, wants = spec_masks(bits, list(collect) + list(tee))
    # the arena: the histogram rows (one more, kept zero, for prefixes no
    # key holds), the collect counts, the certificate, the done and ticket
    # counters, the sketch counters, the extremes, the look-back words
    hist_words = (nd + 1) * nb if prefixes is not None and len(prefixes) else 0
    off_counts = hist_words
    off_cert = off_counts + n_surv
    off_done = off_cert + 2
    off_deep = off_done + 2
    off_ext = off_deep + (1 << sketch_bits if sketch_bits else 0)
    off_ext += off_ext & 1  # 8-byte aligned
    off_status = off_ext + bits // 16
    return _Layout(
        groups=tuple(groups), rows=tuple(rows), identity=rows == list(range(len(rows))),
        specs=_host_words(masks + wants, bits), spec_words=tuple(masks + wants), n_surv=n_surv,
        hist_words=hist_words, off_counts=off_counts, off_cert=off_cert, off_done=off_done,
        off_deep=off_deep, off_ext=off_ext, off_status=off_status,
        total=off_status + 2 * n_surv * groups[0][2].n_tiles,
    )


def sweep_ingest(data, n_valid, *, key_op="none", key_xor=0, shift=0, radix_bits=1,
                 hist_prefixes=None, collect=(), tee=(), vkey=None, sketch_bits=0):
    """Every enabled part of one staged bucket from one read: see the
    module docstring for ``(hist, collect, tee, cert, sketch)``.
    ``hist_prefixes`` is None or a sequence of key prefixes; ``collect`` and
    ``tee`` are sequences of ``(shift, prefix)`` specs (``shift`` = key
    bits - resolved bits, up to the word width); ``vkey`` is None or a
    key; ``sketch_bits`` is 0 (off) up to 20."""
    n_valid = int(n_valid)
    collect, tee = list(collect), list(tee)
    w = _check(data, n_valid, key_op, shift, radix_bits, hist_prefixes, collect, tee, sketch_bits)
    if resolve_hist_method(w.device) == "plain":
        PLAIN_CALLS["sweep_ingest"] += 1
        return sweep_ingest_plain(
            w, n_valid, key_op=key_op, key_xor=key_xor, shift=shift, radix_bits=radix_bits,
            hist_prefixes=hist_prefixes, collect=collect, tee=tee, vkey=vkey, sketch_bits=sketch_bits,
        )
    bits = w.element_size() * 8
    dev = w.device
    n = w.numel()
    nb = 1 << radix_bits
    nq = 0 if hist_prefixes is None else len(hist_prefixes)
    sms = _sm_count(dev)
    lay = _layout(bits, n, shift, radix_bits, None if hist_prefixes is None else tuple(int(p) for p in hist_prefixes),
                  tuple((int(s), int(p)) for s, p in collect), tuple((int(s), int(p)) for s, p in tee),
                  sketch_bits, sms)
    # one arena of int32 words, cleared by the launch's one memset; every
    # word of a survivor buffer is written by the kernel: the survivors,
    # then zeros
    arena = torch.empty(lay.total, dtype=torch.int32, device=dev)
    surv = torch.empty((lay.n_surv, n), dtype=w.dtype, device=dev)
    base = arena.data_ptr()
    if n:
        lib = _lib()
        fn = getattr(lib, f"ksel_sweep_ingest{bits}")
        xor = (key_xor & ((1 << bits) - 1)) if key_op == "xor" else 0
        first = lay.groups[0][2]
        spec_dev = None if first.specs_by_value else _on_device(lay.spec_words, w)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            for g, (group, host, plan) in enumerate(lay.groups):
                pref_dev = None if plan.prefixes_by_value else _on_device(group, w)
                rc = fn(
                    w.data_ptr(), n, n_valid, int(key_op == "float"), xor,
                    len(group), ctypes.cast(host, ctypes.c_void_p), pref_dev.data_ptr() if pref_dev is not None else None,
                    shift, radix_bits, bits - shift - radix_bits, plan.tbits, plan.copies, plan.hist_smem,
                    len(collect) if g == 0 else 0, len(tee) if g == 0 else 0,
                    ctypes.cast(lay.specs, ctypes.c_void_p), spec_dev.data_ptr() if spec_dev is not None else None,
                    int(g == 0 and vkey is not None), 0 if vkey is None else int(vkey),
                    sketch_bits if g == 0 else 0, plan.deep_smem,
                    base + 4 * g * MAX_TABLE_PREFIXES * nb, base + 4 * lay.off_counts, base + 4 * lay.off_cert,
                    base + 4 * lay.off_deep, base + 4 * lay.off_ext, base + 4 * lay.off_done,
                    base + 4 * lay.off_done + 4, base + 4 * lay.off_status, surv.data_ptr(),
                    base, 4 * lay.total if g == 0 else 0, plan.blocks, sms, stream,
                )
                if rc != 0:
                    raise RuntimeError(
                        f"sweep_ingest{bits} launch failed: {lib.ksel_sweep_error_string(rc).decode()}"
                    )
                LAUNCHES[f"sweep_ingest{bits}"] += 1
    else:
        arena.zero_()
        if sketch_bits:
            arena[lay.off_ext:lay.off_status].view(w.dtype)[0] = -1  # no launch: the minimum's identity
    hist = None
    if nq:
        region = arena[:lay.hist_words].view(-1, nb)
        hist = region[:nq] if lay.identity else torch.stack([region[r] for r in lay.rows])
    elif hist_prefixes is not None:
        hist = torch.zeros((0, nb), dtype=torch.int32, device=dev)
    counts = arena[lay.off_counts:lay.off_cert]
    pairs = [(surv[j], counts[j]) for j in range(lay.n_surv)]
    cert = arena[lay.off_cert:lay.off_done] if vkey is not None else None
    sketch = None
    if sketch_bits:
        ext = arena[lay.off_ext:lay.off_status].view(w.dtype)
        sketch = (arena[lay.off_deep:lay.off_deep + (1 << sketch_bits)], ext[0], ext[1])
    return (
        hist,
        tuple(pairs[: len(collect)]),
        pairs[-1] if tee else None,
        (cert[0], cert[1]) if cert is not None else None,
        sketch,
    )
