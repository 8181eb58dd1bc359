"""The select and top-k paths' Hopper kernels: wrappers, plain versions
and counters.

Counterpart of ``mpi_k_selection_tpu/ops/pallas/histogram.py``. Four
functions, each a CUDA kernel (``csrc/histogram.cu``) behind a wrapper:

- :func:`radix_histogram` — the ``(2^radix_bits,)`` int64 counts of the
  digit at ``shift`` over the keys whose bits above the digit equal
  ``prefix``. It replaces ``pallas_radix_histogram`` (32-bit words) and
  ``pallas_radix_histogram64`` (64-bit words).
- :func:`match_counts` — the ``(K, R)`` int32 counts, per 128-element row,
  of the keys whose top ``resolved_bits`` bits equal each of K prefixes. It
  replaces ``pallas_match_counts``.
- :func:`radix_histogram_multi` — the ``(K, 2^radix_bits)`` int64 digit
  histograms under each of K prefixes, in one read. It replaces
  ``pallas_radix_histogram_multi`` and ``pallas_radix_histogram64_multi``.
- :func:`tau_counts` — the ``(2, R)`` int32 counts, per 128-element row, of
  the keys strictly beyond one full-width key tau and of those equal to it.
  It replaces ``pallas_tau_counts``.

Digits of up to 8 bits count on ``csrc/histogram.cu``; digits of 9 to 16
bits (the JAX package takes any width that divides the key bits) count on
the sweep kernel's histogram part (ops/cuda/sweep_ingest.py:
:func:`~mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest.wide_histogram`),
which holds 2^16 counters.

All read RAW words — the input's own bits, viewed as int32 or int64 — and
apply the sortable-key transform on the fly (``key_op``: ``"none"``,
``"xor"`` with ``key_xor``, or ``"float"``; utils/dtypes.py:key_fold).
Prefixes are key-space values in the carrier dtype (int32 / int64 bit
patterns) and stay on the device.

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it computes the same function with plain tensor ops
(the ``*_plain`` functions). ``LAUNCHES``
counts kernel launches and ``PLAIN_CALLS`` the plain versions' calls, so a
run can show which one it went through.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_k_selection_tpu_torch.ops.cuda.books import Book
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

ROW = 128  # elements per row of match_counts (the collect's gather unit)
NARROW_BITS = 8  # the widest digit csrc/histogram.cu counts
WIDE_BITS = 16  # the widest digit of the histogram wrappers (the sweep kernel above NARROW_BITS)
KEY_OPS = ("none", "xor", "float")

LAUNCHES = Book({
    "radix_histogram32": 0,
    "radix_histogram64": 0,
    "match_counts32": 0,
    "match_counts64": 0,
    "radix_histogram_multi32": 0,
    "radix_histogram_multi64": 0,
    "tau_counts32": 0,
    "tau_counts64": 0,
})
PLAIN_CALLS = Book({"radix_histogram": 0, "match_counts": 0, "radix_histogram_multi": 0, "tau_counts": 0})

_THREADS = 256  # kThreads in csrc/histogram.cu
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM
# radix_histogram_multi: the prefix table's bits and queries per launch
# (kTableBits, kMaxMultiQueries in csrc/histogram.cu); the shared memory of
# a block that leaves two on an SM (228 KB, 1 KB reserved each); and the
# most that sub-histogram copies may take. The shared memory of the blocks
# an SM holds comes out of its L1 cache, which holds their 16-byte loads
# in flight, so copies stop at an eighth of the SM's.
MULTI_TABLE_BITS = 12
MULTI_MAX_QUERIES = 1 << (MULTI_TABLE_BITS - 1)
MULTI_SMEM_PER_BLOCK = 228 * 1024 // 2 - 1024
MULTI_COPIES_SMEM = 228 * 1024 // 8


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for name in d:
            d[name] = 0


def resolve_hist_method(device) -> str:
    """The histogram method for tensors on ``device``: ``"cuda"`` (the
    kernel) for a CUDA device, ``"plain"`` (its plain version) for the CPU;
    any other device raises."""
    kind = torch.device(device).type
    method = {"cuda": "cuda", "cpu": "plain"}.get(kind)
    if method is None:
        raise ValueError(f"the histogram kernels run on CUDA or CPU tensors, got {device}")
    return method


def _signed_words(words: torch.Tensor) -> torch.Tensor:
    """``words`` (1-D, any 4- or 8-byte dtype) as its int32/int64 view."""
    if words.dim() != 1:
        raise ValueError(f"words must be 1-D, got shape {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    size = words.element_size()
    if size not in (4, 8):
        raise ValueError(f"words must be a 4- or 8-byte dtype, got {words.dtype}")
    return words.view(torch.int32 if size == 4 else torch.int64)


def _check_key_op(key_op: str) -> None:
    if key_op not in KEY_OPS:
        raise ValueError(f"unknown key_op {key_op!r}; choose from {KEY_OPS}")


def _check_width(radix_bits: int) -> None:
    if not 1 <= radix_bits <= WIDE_BITS:
        raise ValueError(f"radix_bits={radix_bits} outside [1, {WIDE_BITS}]")


def _check_keys_like(t: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if t.device != w.device or t.dtype != w.dtype or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {w.dtype} tensor on {w.device}, "
            f"got {t.dtype} on {t.device}"
        )


def radix_histogram_plain(words, *, shift, radix_bits, prefix=None, key_op="none", key_xor=0):
    """Plain PyTorch version of :func:`radix_histogram` (same contract)."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    nb = 1 << radix_bits
    key = _dt.keys_from_raw(w, key_op, key_xor)
    digit = _dt.shift_right_logical(key, shift, bits) & (nb - 1)
    if prefix is not None:
        active = _dt.shift_right_logical(key, shift + radix_bits, bits) == prefix
        digit = torch.where(active, digit, nb)  # inactive keys: an extra bin
    return torch.bincount(digit, minlength=nb + 1)[:nb]


def match_counts_plain(words, *, resolved_bits, prefixes, key_op="none", key_xor=0):
    """Plain PyTorch version of :func:`match_counts` (same contract)."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    n = w.numel()
    rows = -(-n // ROW)
    top = _dt.shift_right_logical(_dt.keys_from_raw(w, key_op, key_xor), bits - resolved_bits, bits)
    match = top[None, :] == prefixes[:, None]  # (K, n)
    match = torch.nn.functional.pad(match, (0, rows * ROW - n))  # tail: no match
    return match.view(-1, rows, ROW).sum(dim=2, dtype=torch.int32)


def radix_histogram_multi_plain(words, *, shift, radix_bits, prefixes, key_op="none", key_xor=0):
    """Plain PyTorch version of :func:`radix_histogram_multi` (same
    contract): one masked bincount per prefix."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    nb = 1 << radix_bits
    key = _dt.keys_from_raw(w, key_op, key_xor)
    digit = _dt.shift_right_logical(key, shift, bits) & (nb - 1)
    top = _dt.shift_right_logical(key, shift + radix_bits, bits)
    return torch.stack([
        torch.bincount(torch.where(top == p, digit, nb), minlength=nb + 1)[:nb] for p in prefixes
    ])


def tau_counts_plain(words, *, tau, largest=True, key_op="none", key_xor=0):
    """Plain PyTorch version of :func:`tau_counts` (same contract)."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    n = w.numel()
    rows = -(-n // ROW)
    key = _dt.keys_from_raw(w, key_op, key_xor)
    kb, tb = _dt.order_bias(key, bits), _dt.order_bias(tau, bits)  # signed order = key order
    beyond = kb > tb if largest else kb < tb
    match = torch.stack([beyond, key == tau])
    match = torch.nn.functional.pad(match, (0, rows * ROW - n))  # tail: no match
    return match.view(2, rows, ROW).sum(dim=2, dtype=torch.int32)


def _lib():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    lib = build.load("histogram")
    if not getattr(lib, "_ksel_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for bits, xt in ((32, ctypes.c_uint32), (64, ctypes.c_uint64)):
            f = getattr(lib, f"ksel_radix_histogram{bits}")
            f.argtypes = [p, ll, i, i, i, xt, p, p, i, p]
            f.restype = i
            f = getattr(lib, f"ksel_match_counts{bits}")
            f.argtypes = [p, ll, ll, i, i, xt, p, i, p, i, p]
            f.restype = i
            f = getattr(lib, f"ksel_radix_histogram_multi{bits}")
            f.argtypes = [p, ll, i, i, i, xt, p, i, i, p, i, p]
            f.restype = i
            f = getattr(lib, f"ksel_tau_counts{bits}")
            f.argtypes = [p, ll, ll, i, xt, p, i, p, i, p]
            f.restype = i
        lib.ksel_error_string.argtypes = [i]
        lib.ksel_error_string.restype = ctypes.c_char_p
        lib._ksel_typed = True
    return lib


def _launch_args(w: torch.Tensor, key_op: str, key_xor: int):
    """(library, blocks cap, stream, is_float, unsigned xor) for a launch."""
    bits = w.element_size() * 8
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    stream = torch.cuda.current_stream(w.device).cuda_stream
    xor = (key_xor & ((1 << bits) - 1)) if key_op == "xor" else 0
    return _lib(), sms * _BLOCKS_PER_SM, stream, int(key_op == "float"), xor


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.ksel_error_string(rc).decode()}")


def radix_histogram(words, *, shift, radix_bits, prefix=None, key_op="none", key_xor=0):
    """``(2^radix_bits,)`` int64 counts of the digit ``(key >> shift) &
    (2^radix_bits - 1)`` over the keys whose bits above the digit equal
    ``prefix`` (every key when ``prefix`` is None), where ``key`` is the
    sortable key of each raw word of ``words`` under ``key_op``.

    ``words`` is a contiguous 1-D tensor of a 4- or 8-byte dtype, read in
    place. ``prefix`` is a one-element tensor of the words' int32/int64
    view dtype on the same device."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    _check_key_op(key_op)
    _check_width(radix_bits)
    if shift < 0 or shift + radix_bits > bits:
        raise ValueError(f"digit at shift={shift}, radix_bits={radix_bits} outside a {bits}-bit key")
    if prefix is not None:
        _check_keys_like(prefix, w, "prefix")
        if prefix.numel() != 1 or shift + radix_bits == bits:
            raise ValueError("prefix must be one key with prefix bits above the digit")
    elif radix_bits > NARROW_BITS and shift + radix_bits < bits:
        raise ValueError(
            f"a digit of {radix_bits} bits below the key's top (shift={shift} in a {bits}-bit key) "
            "counts under a prefix"
        )
    if resolve_hist_method(w.device) == "plain":
        PLAIN_CALLS["radix_histogram"] += 1
        return radix_histogram_plain(
            w, shift=shift, radix_bits=radix_bits, prefix=prefix, key_op=key_op, key_xor=key_xor
        )
    if radix_bits > NARROW_BITS:  # the sweep kernel's histogram part
        from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import wide_histogram

        return wide_histogram(w, shift=shift, radix_bits=radix_bits, prefixes=[0] if prefix is None else prefix,
                              key_op=key_op, key_xor=key_xor)[0]
    lib, cap, stream, is_float, xor = _launch_args(w, key_op, key_xor)
    n = w.numel()
    out = torch.zeros(1 << radix_bits, dtype=torch.int64, device=w.device)
    if n == 0:
        return out
    blocks = max(1, min(cap, -(-n // (_THREADS * 16))))
    # a warp's shared sub-histogram bins are 32-bit; a thread takes at
    # most ceil(n / threads) keys plus part of one 16-byte load
    if (-(-n // (blocks * _THREADS)) + 4) * 32 >= 1 << 32:
        raise ValueError(f"n={n} overflows the per-warp counters")
    with torch.cuda.device(w.device):
        rc = getattr(lib, f"ksel_radix_histogram{bits}")(
            w.data_ptr(), n, shift, radix_bits, is_float, xor,
            None if prefix is None else prefix.data_ptr(), out.data_ptr(), blocks, stream,
        )
    _raise_on(lib, rc, f"radix_histogram{bits}")
    LAUNCHES[f"radix_histogram{bits}"] += 1
    return out


def match_counts(words, *, resolved_bits, prefixes, key_op="none", key_xor=0):
    """``(K, R)`` int32 counts, ``R = ceil(n / 128)``: ``out[q, r]`` is the
    number of elements ``r*128 .. r*128+127`` of ``words`` whose key's top
    ``resolved_bits`` bits equal ``prefixes[q]``. Keys as in
    :func:`radix_histogram`; ``prefixes`` is a contiguous (K,) tensor of
    the words' int32/int64 view dtype on the same device."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    _check_key_op(key_op)
    if not 1 <= resolved_bits <= bits:
        raise ValueError(f"resolved_bits={resolved_bits} outside a {bits}-bit key")
    _check_keys_like(prefixes, w, "prefixes")
    if prefixes.dim() != 1 or prefixes.numel() == 0:
        raise ValueError(f"prefixes must be a non-empty (K,) tensor, got {tuple(prefixes.shape)}")
    if resolve_hist_method(w.device) == "plain":
        PLAIN_CALLS["match_counts"] += 1
        return match_counts_plain(
            w, resolved_bits=resolved_bits, prefixes=prefixes, key_op=key_op, key_xor=key_xor
        )
    lib, cap, stream, is_float, xor = _launch_args(w, key_op, key_xor)
    n = w.numel()
    rows = -(-n // ROW)
    nq = prefixes.numel()
    out = torch.empty((nq, rows), dtype=torch.int32, device=w.device)
    if n == 0:
        return out
    blocks = max(1, min(cap, -(-rows // (_THREADS // 32))))
    with torch.cuda.device(w.device):
        rc = getattr(lib, f"ksel_match_counts{bits}")(
            w.data_ptr(), n, rows, bits - resolved_bits, is_float, xor,
            prefixes.data_ptr(), nq, out.data_ptr(), blocks, stream,
        )
    _raise_on(lib, rc, f"match_counts{bits}")
    LAUNCHES[f"match_counts{bits}"] += 1
    return out


def _multi_smem_bytes(bits: int, radix_bits: int, table_bits: int, nq: int, copies: int) -> int:
    """Shared memory of one radix_histogram_multi block
    (``csrc/histogram.cu:multi_smem_bytes``): the smallest and largest
    prefix, the nq prefixes, ``copies`` sub-histograms of (nq, 2^radix_bits)
    uint32 counters, the nq owners and the 2^table_bits entries of the
    prefix table (16 bits each)."""
    return 16 + nq * (bits // 8) + copies * nq * (4 << radix_bits) + 2 * nq + (2 << table_bits)


def multi_plan(bits: int, shift: int, radix_bits: int, nq: int) -> tuple[int, int]:
    """(queries per launch, sub-histogram copies) of radix_histogram_multi.
    Copies: the most of 8, 4, 2, 1 with which the block's shared memory
    stays within ``MULTI_COPIES_SMEM``, else 1. Queries per launch: all nq
    (at most ``MULTI_MAX_QUERIES``) if that block leaves two on an SM, else
    as many as fit such a block with one copy."""
    table_bits = min(bits - shift - radix_bits, MULTI_TABLE_BITS)
    q = min(nq, MULTI_MAX_QUERIES)
    fixed = _multi_smem_bytes(bits, radix_bits, table_bits, 0, 1)
    per_query = _multi_smem_bytes(bits, radix_bits, table_bits, 1, 1) - fixed
    q = min(q, (MULTI_SMEM_PER_BLOCK - fixed) // per_query)
    fits = [c for c in (8, 4, 2) if _multi_smem_bytes(bits, radix_bits, table_bits, q, c) <= MULTI_COPIES_SMEM]
    return q, (fits + [1])[0]


def radix_histogram_multi(words, *, shift, radix_bits, prefixes, key_op="none", key_xor=0):
    """``(K, 2^radix_bits)`` int64 counts: row q is :func:`radix_histogram`
    under ``prefixes[q]``, all K from one read of ``words``. Repeated
    prefixes each get the whole histogram. Keys as in
    :func:`radix_histogram`; ``prefixes`` is a contiguous non-empty (K,)
    tensor of the words' int32/int64 view dtype on the same device, and
    every query has prefix bits above the digit."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    _check_key_op(key_op)
    _check_width(radix_bits)
    if shift < 0 or shift + radix_bits >= bits:
        raise ValueError(
            f"digit at shift={shift}, radix_bits={radix_bits} leaves no prefix bits in a {bits}-bit key"
        )
    _check_keys_like(prefixes, w, "prefixes")
    if prefixes.dim() != 1 or prefixes.numel() == 0:
        raise ValueError(f"prefixes must be a non-empty (K,) tensor, got {tuple(prefixes.shape)}")
    if resolve_hist_method(w.device) == "plain":
        PLAIN_CALLS["radix_histogram_multi"] += 1
        return radix_histogram_multi_plain(
            w, shift=shift, radix_bits=radix_bits, prefixes=prefixes, key_op=key_op, key_xor=key_xor
        )
    if radix_bits > NARROW_BITS:  # the sweep kernel's histogram part
        from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import wide_histogram

        return wide_histogram(w, shift=shift, radix_bits=radix_bits, prefixes=prefixes, key_op=key_op, key_xor=key_xor)
    lib, cap, stream, is_float, xor = _launch_args(w, key_op, key_xor)
    n = w.numel()
    nq = prefixes.numel()
    out = torch.zeros((nq, 1 << radix_bits), dtype=torch.int64, device=w.device)
    if n == 0:
        return out
    per_launch, copies = multi_plan(bits, shift, radix_bits, nq)
    # the kernel clamps the grid to the blocks resident at once, at least
    # one per SM; a sub-histogram is shared by at most all of a block's
    # threads, each of which counts ceil(n / threads) keys plus part of
    # one 16-byte load
    blocks = max(1, min(cap, -(-n // (_THREADS * 16))))
    fewest = min(blocks, cap // _BLOCKS_PER_SM)
    if (-(-n // (fewest * _THREADS)) + 4) * _THREADS >= 1 << 32:
        raise ValueError(f"n={n} overflows the per-block counters")
    with torch.cuda.device(w.device):
        for q0 in range(0, nq, per_launch):
            q1 = min(nq, q0 + per_launch)
            rc = getattr(lib, f"ksel_radix_histogram_multi{bits}")(
                w.data_ptr(), n, shift, radix_bits, is_float, xor,
                prefixes[q0:q1].data_ptr(), q1 - q0, copies, out[q0:q1].data_ptr(), blocks, stream,
            )
            _raise_on(lib, rc, f"radix_histogram_multi{bits}")
            LAUNCHES[f"radix_histogram_multi{bits}"] += 1
    return out


def tau_counts(words, *, tau, largest=True, key_op="none", key_xor=0):
    """``(2, R)`` int32 counts, ``R = ceil(n / 128)``: ``out[0, r]`` is the
    number of elements ``r*128 .. r*128+127`` of ``words`` whose key is
    strictly greater than ``tau`` (``largest``) or strictly less (else), in
    unsigned key order, and ``out[1, r]`` the number equal to it. Keys as
    in :func:`radix_histogram`; ``tau`` is a one-element key-space tensor of
    the words' int32/int64 view dtype on the same device."""
    w = _signed_words(words)
    bits = w.element_size() * 8
    _check_key_op(key_op)
    _check_keys_like(tau, w, "tau")
    if tau.numel() != 1:
        raise ValueError(f"tau must hold one key, got shape {tuple(tau.shape)}")
    if resolve_hist_method(w.device) == "plain":
        PLAIN_CALLS["tau_counts"] += 1
        return tau_counts_plain(w, tau=tau, largest=largest, key_op=key_op, key_xor=key_xor)
    lib, cap, stream, is_float, xor = _launch_args(w, key_op, key_xor)
    n = w.numel()
    rows = -(-n // ROW)
    out = torch.empty((2, rows), dtype=torch.int32, device=w.device)
    if n == 0:
        return out
    blocks = max(1, min(cap, -(-rows // (_THREADS // 32))))
    with torch.cuda.device(w.device):
        rc = getattr(lib, f"ksel_tau_counts{bits}")(
            w.data_ptr(), n, rows, is_float, xor, tau.data_ptr(), int(largest),
            out.data_ptr(), blocks, stream,
        )
    _raise_on(lib, rc, f"tau_counts{bits}")
    LAUNCHES[f"tau_counts{bits}"] += 1
    return out
