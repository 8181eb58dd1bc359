"""Exact k-selection over chunked streams
(counterpart of ``mpi_k_selection_tpu/streaming/chunked.py``).

The resident paths need the whole array on one device. Here the input is
a replayable *chunk source*, and each radix pass streams the chunks
through the card one at a time (streaming/pipeline.py stages them, the
sweep kernel reads each once, streaming/executor.py folds the results):
ONE digit histogram per distinct surviving prefix for the whole stream,
accumulated on the host in int64, so the walk is exact for any ``n``
(each chunk holds fewer than 2^31 elements). The state between passes is
each rank's (prefix, rebased k), so chunks are discarded and replayed
between passes: the reference CGM's scan, summarise, discard, repeat
(``TODO-kth-problem-cgm.c:103-293``) applied across time.

As soon as a rank's surviving population fits ``collect_budget``, one
more pass collects its survivors to the host and a partition finishes it.
Every rank shares each pass; ranks that finish early park until the
collect. Keys are the sortable keys of utils/dtypes.py, so the answers
are in the keys' total order (``-0.0 < +0.0``, ``-nan`` first, ``+nan``
last), as the JAX package's streamed answers are.

Every chunk is staged on the device (``device``, default ``"cuda"``), at
``pipeline_depth`` 0 on the caller's thread, else on a producer thread
that stages chunk *i+1* while chunk *i* is consumed; answers are the same
at every depth. ``ingest_workers`` is checked as the JAX package checks
it, and every width runs that one producer (streaming/pipeline.py). A CPU
``device`` runs the kernel's plain version.

A :class:`~mpi_k_selection_tpu_torch.streaming.sketch.RadixSketch` built
over the same stream (``sketch=``) seeds the descent: its deepest level
resolves the first ``sketch.resolution_bits`` key bits, so those passes
are skipped (``RadixSketch.refine``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import MAX_BITS
from mpi_k_selection_tpu_torch.streaming import executor as _ex
from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
from mpi_k_selection_tpu_torch.streaming.pipeline import DEFAULT_PIPELINE_DEPTH
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

DEFAULT_COLLECT_BUDGET = 1 << 20


class _OneShotSource:
    """A bare iterator as a chunk source that may be read once (a
    monitor's stream); a second read is a bug and raises instead of
    yielding an empty stream."""

    def __init__(self, it):
        self._it = iter(it)
        self._used = False

    def __call__(self):
        if self._used:
            raise RuntimeError("one-shot chunk source invoked a second time")
        self._used = True
        return self._it


def as_chunk_source(source, *, one_shot_ok: bool = False):
    """``source`` as a zero-arg callable returning a fresh chunk iterator,
    the replayable form every pass needs: a list or tuple of chunks (numpy
    arrays or torch tensors), one array (one chunk), or such a callable.
    A one-shot iterator is accepted only under ``one_shot_ok`` (a reader of
    one pass, such as the monitor); otherwise it is rejected: exact
    selection re-reads the stream once per radix pass."""
    if callable(source):
        return source
    if isinstance(source, (list, tuple)):
        return lambda: iter(source)
    if isinstance(source, (np.ndarray, torch.Tensor)):
        return lambda: iter((source,))
    if hasattr(source, "__iter__") or hasattr(source, "__next__"):
        if one_shot_ok:
            return _OneShotSource(source)
        raise TypeError(
            "streaming selection re-reads the data once per radix pass; a "
            "one-shot iterator/generator cannot be replayed. Pass a "
            "list/tuple of chunks or a zero-arg callable returning a fresh "
            "iterator (e.g. lambda: (load(i) for i in range(nchunks))). For "
            "single-pass approximate answers, RadixSketch alone suffices."
        )
    raise TypeError(f"unsupported chunk source type {type(source).__name__!r}")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _normalize_chunk(chunk, dtype):
    """One chunk raveled (a 1-D numpy array or tensor) and checked, or None
    for an empty chunk: the 2^31 per-chunk guard and the one-dtype-per-
    stream check against ``dtype`` (None: the first chunk, whose dtype the
    caller adopts)."""
    c = chunk.reshape(-1) if isinstance(chunk, torch.Tensor) else np.ravel(np.asarray(chunk))
    n = c.numel() if isinstance(c, torch.Tensor) else c.size
    if n == 0:
        return None
    if n >= 1 << 31:
        raise ValueError(
            f"chunk of {n} elements: per-chunk device histogram counts are "
            "int32-exact only below 2^31 elements — split the stream into "
            "smaller chunks (n is unbounded, chunks are not)"
        )
    cdt = _dt.torch_dtype(c.dtype)
    if dtype is not None and cdt != dtype:
        raise TypeError(
            f"chunk dtype {_dtype_name(cdt)} != stream dtype {_dtype_name(dtype)}; "
            "streaming selection requires one dtype per stream"
        )
    return c


def _iter_staged(src, dtype, device):
    """The synchronous ``(StagedKeys, dtype)`` iterator (depth 0): each
    chunk is staged on the caller's thread when the descent asks for it."""
    stager = (
        _pl.HostStager(device, torch.cuda.current_stream(device)) if device.type == "cuda" else None
    )
    for chunk in src():
        c = _normalize_chunk(chunk, dtype)
        if c is None:
            continue
        if dtype is None:
            dtype = _dt.torch_dtype(c.dtype)
        yield _pl.stage_chunk(c, dtype, device, stager), dtype


@contextlib.contextmanager
def _key_chunk_stream(src, dtype, *, pipeline_depth: int, device):
    """The pass's ``(StagedKeys, dtype)`` iterator; a pipelined one is
    closed (its thread joined) on every exit."""
    if pipeline_depth == 0:
        yield _iter_staged(src, dtype, device)
        return
    pipe = _pl.ChunkPipeline(src, dtype, depth=pipeline_depth, device=device)
    try:
        yield iter(pipe)
    finally:
        pipe.close()


def _stream_pass(src, dtype, make_consumer, *, pipeline_depth: int, device):
    """Stream every chunk of ``src`` through one consumer, built by
    ``make_consumer(dtype)`` at the first chunk. Returns ``(consumer,
    dtype, n)``; the consumer is None for an empty stream."""
    consumer = ex = keys = None
    n = 0
    try:
        with _key_chunk_stream(src, dtype, pipeline_depth=pipeline_depth, device=device) as chunks:
            for keys, dtype in chunks:
                if consumer is None:
                    consumer = make_consumer(dtype)
                    ex = _ex.StreamExecutor([consumer])
                n += keys.size
                ex.push(keys)
            if ex is not None:
                ex.drain()
    except BaseException:
        if ex is not None:
            ex.abort()
        _ex.release_staged(keys)  # the chunk in hand (idempotent)
        raise
    return consumer, dtype, n


def _np_walk(hist, kk, prefix, radix_bits):
    """Host bucket-walk step: pick the bucket holding the kk-th survivor,
    rebase kk, extend the prefix. Returns (prefix, kk, bucket_count)."""
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, kk, side="left"))
    kk = int(kk - (cum[b - 1] if b else 0))
    prefix = ((int(prefix) << radix_bits) | b) if prefix is not None else b
    return prefix, kk, int(hist[b])


def _validate_ks(ks, n):
    for k in ks:
        if not 1 <= k <= n:
            raise ValueError(f"k={k} out of range [1, {n}]")


def _collect_survivors(src, dtype, specs, *, pipeline_depth, device):
    """One pass collecting the survivors of EVERY ``(resolved_bits,
    prefix) -> expected population`` spec, filtered on the device so only
    survivors cross to the host. Returns ``{spec: host key array}``."""
    total_bits = _dt.key_bits(dtype)
    sorted_specs = sorted(specs)
    collector, _, _ = _stream_pass(
        src, dtype,
        lambda _: _ex.FusedIngestConsumer(total_bits=total_bits, collect_specs=sorted_specs),
        pipeline_depth=pipeline_depth, device=device,
    )
    collected = collector.collected(np.uint64 if total_bits == 64 else np.uint32)
    for spec in sorted_specs:
        if collected[spec].size != specs[spec]:
            raise RuntimeError(
                f"chunk source is not replay-stable: collected {collected[spec].size} "
                f"survivors, histogram pass counted {specs[spec]}. The source "
                "callable must yield identical data on every invocation."
            )
    return collected


def streaming_kselect(source, k, *, radix_bits: int = 8, collect_budget: int = DEFAULT_COLLECT_BUDGET,
                      sketch=None, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                      device=None):
    """Exact k-th smallest (1-indexed) over a chunked stream: a host
    scalar of the stream's dtype (numpy; ml_dtypes' bfloat16 for
    bfloat16), bit for bit the JAX package's ``streaming_kselect``.

    ``source`` per :func:`as_chunk_source`. ``radix_bits`` is the digit
    width of a pass (it must divide the key bits, or with a ``sketch`` the
    bits below its resolved prefix); ``collect_budget`` bounds the
    survivors a rank collects to the host, and so the passes; ``sketch``
    (a RadixSketch of the same stream) seeds the descent;
    ``pipeline_depth`` (0 = synchronous), ``ingest_workers`` (None,
    ``"auto"`` or an int; checked only) and ``device`` are described in
    the module docstring."""
    return streaming_kselect_many(
        source, [k], radix_bits=radix_bits, collect_budget=collect_budget, sketch=sketch,
        pipeline_depth=pipeline_depth, ingest_workers=ingest_workers, device=device,
    )[0]


def streaming_kselect_many(source, ks, *, radix_bits: int = 8, collect_budget: int = DEFAULT_COLLECT_BUDGET,
                           sketch=None, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                           device=None):
    """Exact k-th smallest for EVERY (1-indexed) rank in ``ks``, as a list
    in ``ks`` order, sharing each pass across ranks: the stream is read
    once per radix level plus one collect, not once per rank, with one
    histogram per DISTINCT surviving prefix at each level. Knobs as
    :func:`streaming_kselect`."""
    depth = _pl.validate_pipeline_depth(pipeline_depth)
    _pl.resolve_ingest_workers(ingest_workers)
    if not 1 <= radix_bits <= MAX_BITS:  # the JAX package's MAX_PASS_BITS
        raise ValueError(f"radix_bits={radix_bits} outside [1, {MAX_BITS}]")
    ks = [int(k) for k in ks]
    if not ks:
        return []
    src = as_chunk_source(source)
    dev = _pl.resolve_device(device)
    run = dict(pipeline_depth=depth, device=dev)

    def first_pass(dtype):
        # pass 0 is also the length scan and the dtype probe: one histogram
        # of the top digit, no prefix filter
        total_bits = _dt.key_bits(dtype)
        if total_bits % radix_bits:
            raise ValueError(f"radix_bits={radix_bits} must divide key bits {total_bits}")
        return _ex.FusedIngestConsumer(total_bits=total_bits, hist=(total_bits - radix_bits, radix_bits, [None]))

    # per-rank descent state: [prefix, rebased k, resolved bits, population]
    if sketch is not None:
        # the sketch names the stream dtype (every chunk is held to it) and
        # resolves its top bits: the passes walk the bits below them
        dtype = _dt.torch_dtype(sketch.dtype)
        sketch.check_stream(dtype, radix_bits)
        n = sketch.n
        _validate_ks(ks, n)
        states = [list(sketch.walk(k)) for k in ks]
    else:
        first, dtype, n = _stream_pass(src, None, first_pass, **run)
        if first is None:
            raise ValueError("streaming selection requires a non-empty stream")
        _validate_ks(ks, n)
        states = []
        for k in ks:
            prefix, kk, pop = _np_walk(first.hists[None], k, None, radix_bits)
            states.append([prefix, kk, radix_bits, pop])
    total_bits = _dt.key_bits(dtype)

    def active(st):
        return st[2] < total_bits and st[3] > collect_budget

    while any(active(st) for st in states):
        # active ranks advance in lockstep, so they sit at one depth: one
        # pass serves every distinct surviving prefix
        resolved = next(st[2] for st in states if active(st))
        shift = total_bits - resolved - radix_bits
        prefixes = sorted({st[0] for st in states if active(st)})
        expected = {st[0]: st[3] for st in states if active(st)}
        consumer, _, _ = _stream_pass(
            src, dtype,
            lambda _: _ex.FusedIngestConsumer(total_bits=total_bits, hist=(shift, radix_bits, prefixes)),
            **run,
        )
        for p in prefixes:
            if int(consumer.hists[p].sum()) != expected[p]:
                raise RuntimeError(
                    f"chunk source is not replay-stable: prefix {p:#x} holds "
                    f"{int(consumer.hists[p].sum())} elements this pass, previous pass "
                    f"counted {expected[p]}. The source callable must yield identical "
                    "data on every invocation."
                )
        for st in states:
            if active(st):
                st[0], st[1], st[3] = _np_walk(consumer.hists[st[0]], st[1], st[0], radix_bits)
                st[2] = resolved + radix_bits

    specs = {(resolved, int(prefix)): pop for prefix, _, resolved, pop in states if resolved < total_bits}
    collected = _collect_survivors(src, dtype, specs, **run) if specs else {}
    np_dtype = numpy_dtype(_dtype_name(dtype))
    kdt = _dt.np_to_sortable_bits(np.zeros(1, np_dtype)).dtype
    answers = []
    for prefix, kk, resolved, _ in states:
        if resolved == total_bits:  # every key bit resolved: the prefix IS the key
            key = prefix
        else:
            key = np.partition(collected[(resolved, int(prefix))], kk - 1)[kk - 1]
        answers.append(_dt.np_from_sortable_bits(np.asarray([key], kdt), np_dtype)[0])
    return answers


def streaming_rank_certificate(source, value, *, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                               device=None):
    """``(#elements < value, #elements <= value)`` over a chunked stream,
    as Python ints: an answer for rank k is exact iff ``less < k <= leq``.
    Compared in key space (ties, ``-0.0``/``+0.0`` and NaNs behave exactly
    as in the selection itself), on the card by the sweep kernel's
    certificate part."""
    depth = _pl.validate_pipeline_depth(pipeline_depth)
    _pl.resolve_ingest_workers(ingest_workers)
    src = as_chunk_source(source)

    def certificate(dtype):
        # key the probe value in the stream's dtype, known at the first chunk
        np_dtype = numpy_dtype(_dtype_name(dtype))
        return _ex.CountLessLeqConsumer(int(_dt.np_to_sortable_bits(np.asarray([value], np_dtype))[0]))

    counter, _, _ = _stream_pass(src, None, certificate, pipeline_depth=depth, device=_pl.resolve_device(device))
    if counter is None:
        raise ValueError("streaming_rank_certificate requires a non-empty stream")
    return counter.less, counter.leq
