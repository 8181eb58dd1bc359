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
``PLAIN_CALLS`` the plain version's calls.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_k_selection_tpu_torch.ops.cuda.histogram import KEY_OPS, resolve_hist_method
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

MAX_BITS = 20  # the widest histogram, a digit or the sketch: 2^20 int32 counters

LAUNCHES = {"sweep_ingest32": 0, "sweep_ingest64": 0}
PLAIN_CALLS = {"sweep_ingest": 0}

_THREADS = 256  # kThreads in csrc/sweep_ingest.cu
_BLOCKS_PER_SM = 8


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
    own copy to the card)."""
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


def _lib():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    lib = build.load("sweep_ingest")
    if not getattr(lib, "_ksel_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for bits, xt in ((32, ctypes.c_uint32), (64, ctypes.c_uint64)):
            f = getattr(lib, f"ksel_sweep_ingest{bits}")
            f.argtypes = [p, ll, ll, i, xt, p, i, i, i, i, i, i, xt, i, p, p, p, p, p, p, p, i, p]
            f.restype = i
        lib.ksel_sweep_error_string.argtypes = [i]
        lib.ksel_sweep_error_string.restype = ctypes.c_char_p
        lib._ksel_typed = True
    return lib


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
    nq = 0 if hist_prefixes is None else len(hist_prefixes)
    nb = 1 << radix_bits
    n_surv = len(collect) + (1 if tee else 0)
    params = _on_device(
        [(int(p) << radix_bits) & ((1 << bits) - 1) for p in (hist_prefixes or ())]
        + [s for s, _ in collect] + [p for _, p in collect] + [s for s, _ in tee] + [p for _, p in tee]
        or [0],
        w,
    )
    hist = torch.zeros((nq, nb), dtype=torch.int32, device=dev)
    counts = torch.zeros(n_surv, dtype=torch.int32, device=dev)
    surv = torch.zeros((n_surv, n), dtype=w.dtype, device=dev)  # zeros after the survivors
    cert = torch.zeros(2, dtype=torch.int32, device=dev)
    deep = torch.zeros(1 << sketch_bits if sketch_bits else 0, dtype=torch.int32, device=dev)
    ext = _on_device([(1 << bits) - 1, 0], w)  # the unsigned min / max identities
    tiles = -(-n // (_THREADS * 64 // w.element_size()))
    scratch = torch.zeros(1 + n_surv * tiles, dtype=torch.int64, device=dev)  # ticket, tile status
    if n:
        lib = _lib()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        xor = (key_xor & ((1 << bits) - 1)) if key_op == "xor" else 0
        with torch.cuda.device(dev):
            rc = getattr(lib, f"ksel_sweep_ingest{bits}")(
                w.data_ptr(), n, n_valid, int(key_op == "float"), xor, params.data_ptr(),
                nq, shift, radix_bits, len(collect), len(tee), int(vkey is not None),
                0 if vkey is None else int(vkey), sketch_bits, hist.data_ptr(), counts.data_ptr(),
                surv.data_ptr(), cert.data_ptr(), deep.data_ptr(), ext.data_ptr(), scratch.data_ptr(),
                sms * _BLOCKS_PER_SM, torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"sweep_ingest{bits} launch failed: {lib.ksel_sweep_error_string(rc).decode()}")
        LAUNCHES[f"sweep_ingest{bits}"] += 1
    pairs = [(surv[j], counts[j]) for j in range(n_surv)]
    return (
        hist if hist_prefixes is not None else None,
        tuple(pairs[: len(collect)]),
        pairs[-1] if tee else None,
        (cert[0], cert[1]) if vkey is not None else None,
        (deep, ext[0], ext[1]) if sketch_bits else None,
    )
