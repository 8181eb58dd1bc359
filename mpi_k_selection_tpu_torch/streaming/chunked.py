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

The ``spill`` knob adds the reference CGM's discard step to the stream
(streaming/spill.py): pass 0 tees each chunk's encoded keys to a
generation on disk (on the host, on the producer thread; grouped on the
card under ``pack_spill="auto"``), and every later
pass reads the previous generation, keeps on the card only the keys under
the surviving prefixes (the sweep kernel's tee part, in the same launch as
the pass's histograms) and writes them as the next generation, so each
pass after the first reads about 1/2^radix_bits of the one before, and a
one-shot source is read once. ``"auto"`` (default) spills only for a
one-shot source, ``"force"`` always, ``"off"`` never (a one-shot source is
then refused); a caller-owned :class:`~mpi_k_selection_tpu_torch.
streaming.spill.SpillStore` keeps its generation 0 for later calls, and a
store with a committed generation is itself a source. Answers are the same
bits in every mode.

``retry`` arms the resilience policies (faults/policy.py; None = the
bounded default, ``"off"`` = fail on the first fault): a replayable
source re-pulls a chunk after a transient error mid-pass
(``resilient_source``), the staging of a chunk to its slot retries in
place, and a pass that fails with a transient error runs again whole,
``max_attempts`` times in all, before ``RetryExhaustedError``. A corrupt
record (``SpillRecordError``) is read again once, then the pass is rebuilt
from the replayable source or a one-shot run's generation 0; running out
of disk (``ENOSPC``) while teeing a later generation degrades ``"auto"`` to
replaying the last good generation (a ``degrade`` FaultEvent and a
RuntimeWarning) and raises ``SpillCapacityError`` otherwise. Only the
transient classes are retried: a CUDA error, a kernel that fails to build
or launch, or running out of device memory propagates untouched. Every
recovery emits a FaultEvent, and a terminal failure dumps the flight
recorder's bundle once (obs/flight.py).

Two knobs cut the descent's bytes, both bit-identical to their ``"off"``
defaults, which are the historical descent byte for byte.
``width_schedule`` sets the digit width of each pass: ``"off"`` is
``radix_bits`` a pass, ``"auto"`` a wide first digit (at most 16 bits,
the rest on ``radix_bits`` boundaries; 64-bit keys a second wide one), or
a tuple of widths summing to the bits to resolve
(:func:`resolve_width_schedule`, resolved at pass 0's dtype probe).
``pack_spill="auto"`` writes spill generations in format v2
(streaming/spill.py): pass 0's records segmented by the top
``GEN0_SEGMENT_BITS`` of each key, a later generation's by the pass's
filter union with only each key's unresolved low bits on disk, and each
later pass reads only the segments under its surviving prefixes.

``devices`` (streaming/pipeline.py:``resolve_stream_devices``: an int p,
or a sequence of cards, a card repeated for two slots on it) spreads the
pipelined passes over cards: chunk *j* is staged onto ``devices[j % p]``
and read there by the sweep kernel, one bundle a slot in flight, and the
host folds the results in chunk order, so answers, pass logs and spill
records are the same bits at every ``p``. It takes effect at
``pipeline_depth >= 1`` only (depth 0 stays the synchronous path, on the
first slot). ``obs`` (obs/:``Observability``) records the descent's
events, metrics and host spans, and ``timer`` (utils/profiling.py:
``PhaseTimer``) its phases; neither changes an answer bit.
"""

from __future__ import annotations

import contextlib
import errno
import warnings

import numpy as np
import torch

from mpi_k_selection_tpu_torch.errors import RetryExhaustedError, SpillCapacityError, SpillRecordError
from mpi_k_selection_tpu_torch.faults import policy as _fp
from mpi_k_selection_tpu_torch.obs import events as _ev
from mpi_k_selection_tpu_torch.obs import flight as _fl
from mpi_k_selection_tpu_torch.obs import ledger as _ldg
from mpi_k_selection_tpu_torch.obs import metrics as _om
from mpi_k_selection_tpu_torch.obs import wiring as _wr
from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import MAX_BITS
from mpi_k_selection_tpu_torch.streaming import executor as _ex
from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
from mpi_k_selection_tpu_torch.streaming import spill as _sp
from mpi_k_selection_tpu_torch.streaming.pipeline import DEFAULT_PIPELINE_DEPTH
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype
from mpi_k_selection_tpu_torch.utils.profiling import phase as _phase

DEFAULT_COLLECT_BUDGET = 1 << 20

#: Default of the ``spill`` knob: spill only when the source cannot be
#: replayed (the JAX package's default).
DEFAULT_SPILL = "auto"

#: The widest digit of one streamed pass (the JAX package's; the sweep
#: kernel's widest histogram, 2^20 int32 counters).
MAX_PASS_BITS = MAX_BITS

#: Defaults of ``width_schedule`` and ``pack_spill`` (the JAX package's):
#: one ``radix_bits`` digit a pass, and format-v1 records.
DEFAULT_WIDTH_SCHEDULE = "off"
DEFAULT_PACK_SPILL = "off"

WIDTH_SCHEDULE_MODES = ("auto", "off")


def validate_width_schedule(width_schedule):
    """Normalize the ``width_schedule`` knob: ``"auto"``, ``"off"`` (None
    = off) or a tuple of per-pass digit widths, each in ``[1,
    MAX_PASS_BITS]``; checked before any stream is read, with the JAX
    package's messages."""
    if width_schedule is None:
        return "off"
    if width_schedule in WIDTH_SCHEDULE_MODES:
        return width_schedule
    bad = ValueError(
        f"width_schedule must be one of {WIDTH_SCHEDULE_MODES} or a tuple of per-pass digit widths, got "
        f"{width_schedule!r}"
    )
    if isinstance(width_schedule, str):
        raise bad
    try:
        widths = tuple(int(w) for w in width_schedule)
    except TypeError:
        raise bad from None
    if not widths:
        raise ValueError("width_schedule tuple must name at least one pass")
    for w in widths:
        if not 1 <= w <= MAX_PASS_BITS:
            raise ValueError(
                f"width_schedule pass width {w} outside [1, {MAX_PASS_BITS}]: a streamed pass histograms 2**width "
                "int32 device partials per in-flight (prefix, chunk) dispatch (KSC102's counter discipline), so "
                f"wider digits would overflow the device histogram budget (2**{MAX_PASS_BITS} bins = 4 MiB); split "
                "the schedule into more passes instead"
            )
    return widths


def _fixed_schedule(total_bits: int, radix_bits: int, start_bits: int) -> tuple:
    """``radix_bits`` a pass over the bits below ``start_bits``, which it
    must divide."""
    remaining = total_bits - start_bits
    if remaining % radix_bits:
        if start_bits:
            raise ValueError(
                f"radix_bits={radix_bits} must divide the {remaining} key bits left below the resolved "
                f"{start_bits} bits"
            )
        raise ValueError(f"radix_bits={radix_bits} must divide key bits {total_bits}")
    return (radix_bits,) * (remaining // radix_bits)


def resolve_width_schedule(width_schedule, total_bits: int, radix_bits: int, start_bits: int = 0) -> tuple:
    """A validated ``width_schedule`` against the stream's key bits: the
    per-pass widths, summing to ``total_bits - start_bits`` (a seeding
    sketch's resolved bits). ``"off"`` is ``radix_bits`` a pass (which
    must divide the bits); ``"auto"`` takes the widest first digit of at
    most 16 bits that leaves the rest on ``radix_bits`` boundaries, and
    where more than 32 bits remain (64-bit keys) a second digit wider than
    ``radix_bits`` by the same rule; a tuple must sum to the bits. The JAX
    package's ``resolve_width_schedule``, message for message."""
    remaining = total_bits - start_bits
    if width_schedule == "off":
        return _fixed_schedule(total_bits, radix_bits, start_bits)
    if width_schedule == "auto":
        for w in range(min(16, remaining), 0, -1):
            if (remaining - w) % radix_bits == 0:
                rem = remaining - w
                head = (w,)
                if rem > 16 and w > radix_bits and remaining > 32:
                    for w2 in range(min(16, rem), radix_bits, -1):
                        if (rem - w2) % radix_bits == 0:
                            head += (w2,)
                            rem -= w2
                            break
                return head + (radix_bits,) * (rem // radix_bits)
        # radix_bits above 16: no first digit fits, so the fixed schedule,
        # with its divisibility check (the JAX package returns a schedule
        # short of the bits here, ROADMAP Queue 3 item 5)
        return _fixed_schedule(total_bits, radix_bits, start_bits)
    widths = tuple(width_schedule)
    if sum(widths) != remaining:
        raise ValueError(
            f"width_schedule {widths} resolves {sum(widths)} bits but the descent must resolve {remaining}"
            + (f" ({total_bits} key bits minus the sketch's {start_bits} resolved)" if start_bits
               else f" ({total_bits} key bits)")
        )
    return widths


def _is_one_shot_source(source) -> bool:
    """True for a bare iterator or generator: it can be read once."""
    if callable(source) or isinstance(source, (list, tuple, np.ndarray, torch.Tensor, _sp.SpillStore)):
        return False
    return hasattr(source, "__iter__") or hasattr(source, "__next__")


class _OneShotSource:
    """A bare iterator as a chunk source that may be read once (the spill
    descent's pass 0, a monitor's stream); a second read is a bug and
    raises instead of yielding an empty stream."""

    def __init__(self, it):
        self._it = iter(it)
        self._used = False

    def __call__(self):
        if self._used:
            raise RuntimeError(
                "one-shot chunk source invoked a second time: the spill descent must serve every pass after "
                "pass 0 from the spill store. This is a bug in streaming/chunked.py, not in the caller's stream."
            )
        self._used = True
        return self._it


def as_chunk_source(source, *, one_shot_ok: bool = False):
    """``source`` as a zero-arg callable returning a fresh chunk iterator,
    the replayable form every pass needs: a list or tuple of chunks (numpy
    arrays or torch tensors), one array (one chunk), such a callable, or a
    :class:`~mpi_k_selection_tpu_torch.streaming.spill.SpillStore` with a
    committed generation (its newest, read from disk). A one-shot iterator is accepted
    only under ``one_shot_ok`` (the spill descent's pass 0, or a reader of
    one pass such as the monitor); otherwise it is refused: exact
    selection re-reads the stream once per radix pass."""
    if isinstance(source, _sp.SpillStore):
        return source.latest_generation().as_source()
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
            "iterator (e.g. lambda: (load(i) for i in range(nchunks))) — or "
            "keep the one-shot stream and let the spill store serve the "
            "later passes: spill='auto'|'force' on the streaming entry "
            "points tees pass 0's encoded keys to disk (streaming/spill.py),"
            " and RadixSketch.update_stream(..., spill=store) does the same "
            "for the sketch-then-refine flow. For single-pass approximate "
            "answers, RadixSketch alone suffices."
        )
    raise TypeError(f"unsupported chunk source type {type(source).__name__!r}")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _normalize_chunk(chunk, dtype):
    """One chunk raveled (a 1-D numpy array or tensor) and checked, or None
    for an empty chunk: the 2^31 per-chunk guard and the one-dtype-per-
    stream check against ``dtype`` (None: the first chunk, whose dtype the
    caller adopts). A replayed spill record (``SpillChunk``) holds keys
    already: its stream dtype is checked and it passes through whole."""
    if isinstance(chunk, _sp.SpillChunk):
        if chunk.keys.size == 0:
            return None
        odt = _dt.torch_dtype(chunk.orig_dtype)
        if dtype is not None and odt != dtype:
            raise TypeError(
                f"spill chunk dtype {_dtype_name(odt)} != stream dtype {_dtype_name(dtype)}; "
                "streaming selection requires one dtype per stream"
            )
        return chunk
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


def _chunk_dtype(c) -> torch.dtype:
    """The stream dtype of a normalized chunk."""
    return _dt.torch_dtype(c.orig_dtype if isinstance(c, _sp.SpillChunk) else c.dtype)


def _np_dtype(dtype) -> np.dtype:
    return numpy_dtype(_dtype_name(dtype))


def _key_np(dtype) -> np.dtype:
    """The unsigned key dtype of a stream dtype (the JAX package's
    ``key_dtype``): its width prices ``bytes_read`` and the chunk events."""
    return np.dtype(f"uint{_dt.key_bits(dtype)}")


def _tee(writer, c, dtype, slot) -> None:
    """Append one normalized chunk's keys, encoded on the host, to the
    pass-0 generation ``writer``, naming ``slot``."""
    if isinstance(c, _sp.SpillChunk):
        keys = c.keys
    elif isinstance(c, torch.Tensor):
        keys = _dt.np_to_sortable_bits(_dt.bit_view(c).cpu().numpy().view(_np_dtype(dtype)))
    else:
        keys = _dt.np_to_sortable_bits(c)
    writer.append(keys, _np_dtype(dtype), device_slot=slot)


def _iter_staged(src, dtype, device, spill=None):
    """The synchronous ``(StagedKeys, dtype)`` iterator (depth 0): each
    chunk is staged on the caller's thread when the descent asks for it
    (after the tee to ``spill``, a SpillWriter, if given; a replayed
    record names its own slot, any other none)."""
    stager = (
        _pl.HostStager(device, torch.cuda.current_stream(device)) if device.type == "cuda" else None
    )
    for chunk in src():
        c = _normalize_chunk(chunk, dtype)
        if c is None:
            continue
        if dtype is None:
            dtype = _chunk_dtype(c)
        slot = c.device_slot if isinstance(c, _sp.SpillChunk) else None
        if spill is not None:
            _tee(spill, c, dtype, slot)
        yield _pl.stage_chunk(c, dtype, device, stager, tee_slot=slot), dtype


@contextlib.contextmanager
def _key_chunk_stream(src, dtype, *, pipeline_depth: int, device, devs=(None,), staged=True, window=1, spill=None,
                      timer=None, retry=None, obs=None):
    """The pass's ``(StagedKeys, dtype)`` iterator; a pipelined one is
    closed (its thread joined) on every exit. At depth >= 1 the producer
    places chunks by a :class:`~mpi_k_selection_tpu_torch.streaming.
    pipeline.SlotCursor` over ``devs`` (``staged``: round-robin slots),
    for a consumer window of ``window`` bundles, and retries the staging
    of a chunk under ``retry`` (its events to ``obs``). ``spill`` tees
    every chunk to a SpillWriter (its records name each chunk's slot)."""
    if pipeline_depth == 0:
        yield _iter_staged(src, dtype, device, spill)
        return
    pipe = _pl.ChunkPipeline(src, dtype, depth=pipeline_depth, cursor=_pl.SlotCursor(device, devs, staged),
                             window=window, spill=spill, timer=timer, retry=retry, obs=obs)
    try:
        yield iter(pipe)
    finally:
        pipe.close()


class _Pass:
    """What a streamed pass read: its consumer (None for an empty stream),
    the stream dtype, the keys, the chunks and the chunks staged to slots."""

    __slots__ = ("consumer", "dtype", "n", "chunks", "staged_chunks")

    def __init__(self):
        self.consumer = self.dtype = None
        self.n = self.chunks = self.staged_chunks = 0


def _stream_pass(src, dtype, make_consumer, *, pipeline_depth: int, device, devs=(None,), staged=True, window=1,
                 spill=None, obs=None, label=None, timer=None, phase=None, occupancy=None, retry=None) -> _Pass:
    """Stream every chunk of ``src`` through one consumer, built by
    ``make_consumer(dtype)`` at the first chunk. ``spill`` tees every chunk
    to a SpillWriter: on the host (:func:`_key_chunk_stream`) for a
    format-v1 writer, through a DigitTeeConsumer for a digit-segmenting
    one. ``devs``, ``staged`` and ``window`` place the chunks and size the
    window (:func:`_key_chunk_stream`). With ``obs``, each chunk emits its
    ChunkEvent under pass ``label``; ``phase`` names the pass's span on
    ``timer``, and ``occupancy`` samples the window. ``retry`` retries the
    staging of a chunk in place (:func:`_key_chunk_stream`). On a raise the
    pass unwinds whole: the window's bundles aborted, the chunk in hand
    released, the producer joined."""
    out = _Pass()
    ex = keys = None
    digit_tee = spill if spill is not None and spill.pack_digit_bits is not None else None
    try:
        with _phase(timer, phase), _key_chunk_stream(
            src, dtype, pipeline_depth=pipeline_depth, device=device, devs=devs, staged=staged, window=window,
            spill=None if digit_tee is not None else spill, timer=timer, retry=retry, obs=obs,
        ) as chunks:
            for keys, dtype in chunks:
                if out.consumer is None:
                    out.consumer = make_consumer(dtype)
                    out.dtype, kdt = dtype, _key_np(dtype)
                    tees = [] if digit_tee is None else [
                        _ex.DigitTeeConsumer(digit_tee, _dt.key_bits(dtype), _np_dtype(dtype))]
                    ex = _ex.StreamExecutor([*tees, out.consumer], window=window, occupancy=occupancy)
                if obs is not None:
                    _wr.chunk_event(obs, label, out.chunks, keys, kdt, devs)
                out.chunks += 1
                out.staged_chunks += keys.staged
                out.n += keys.size
                ex.push(keys)
            if ex is not None:
                ex.drain()
    except BaseException:
        if ex is not None:
            ex.abort()
        _ex.release_staged(keys)  # the chunk in hand (idempotent)
        raise
    if out.dtype is None:
        out.dtype = dtype
    return out


def _hist_summary(hists) -> tuple[int, int, int]:
    """(total population, heaviest bucket, nonzero buckets) across one
    pass's ``{prefix: int64 histogram}``."""
    total = bucket_max = nonzero = 0
    for h in hists.values():
        total += int(h.sum())
        bucket_max = max(bucket_max, int(h.max()))
        nonzero += int(np.count_nonzero(h))
    return total, bucket_max, nonzero


def _generation_event(obs, gen) -> None:
    obs.emit(_ev.SpillGenerationEvent(generation=gen.index, records=len(gen.records), keys=gen.keys,
                                      nbytes=gen.nbytes, logical_nbytes=gen.logical_nbytes, packed=gen.packed))


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


def _collect_survivors(src, dtype, specs, *, run, staged, obs=None, read_from="source", disk_bytes_read=None):
    """One pass collecting the survivors of EVERY ``(resolved_bits,
    prefix) -> expected population`` spec, filtered on the device so only
    survivors cross to the host. Returns ``{spec: host key array}``.
    ``run`` holds the pass knobs (:func:`_stream_pass`); ``staged`` stages
    to round-robin slots (only with ``devices``, as the JAX package's
    collect). With ``obs`` the pass ends in the terminal ``"collect"``
    StreamPassEvent, one collected population a spec."""
    total_bits = _dt.key_bits(dtype)
    kdt = _key_np(dtype)
    sorted_specs = sorted(specs)
    res = _stream_pass(
        src, dtype,
        lambda _: _ex.FusedIngestConsumer(total_bits=total_bits, collect_specs=sorted_specs, obs=obs),
        staged=staged, obs=obs, label="collect", phase="descent.collect",
        occupancy=_wr.window_occupancy(obs, phase="collect"), **run,
    )
    collector = res.consumer
    collected = collector.collected(kdt) if collector is not None else {s: np.empty((0,), kdt) for s in sorted_specs}
    for spec in sorted_specs:
        if collected[spec].size != specs[spec]:
            raise RuntimeError(
                f"chunk source is not replay-stable: collected {collected[spec].size} "
                f"survivors, histogram pass counted {specs[spec]}. The source "
                "callable must yield identical data on every invocation."
            )
    if obs is not None:
        sizes = [int(collected[s].size) for s in sorted_specs]
        obs.emit(_ev.StreamPassEvent(
            pass_index="collect", resolved_bits=0, prefixes=tuple(int(p) for _, p in sorted_specs),
            chunks=res.chunks, keys_read=res.n, bytes_read=res.n * kdt.itemsize,
            disk_bytes_read=res.n * kdt.itemsize if disk_bytes_read is None else int(disk_bytes_read),
            read_from=read_from, bucket_total=sum(sizes), bucket_max=max(sizes, default=0),
            bucket_nonzero=sum(1 for z in sizes if z), survivors=tuple(sizes),
        ))
    return collected


def _emit_fault(obs, site, action, exc=None) -> None:
    """One recovery observation: a FaultEvent and the
    ``faults.recovered{site,action}`` counter."""
    _wr.fault_event(obs, site, action, exc=exc, counter="faults.recovered", labels={"site": site, "action": action})


def _recover_pass(run, *, policy, reading_spill: bool, fallback, on_enospc, obs, site: str):
    """Run ONE streamed pass under the JAX package's recovery ladder.
    ``run(src, tee)`` is a pass body that unwinds completely on raise (its
    window aborted, its writer aborted, the chunk in hand released, the
    producer joined), so every attempt starts clean: ``src=None`` reads the
    pass's own source, ``tee=False`` writes no generation.

    - ``SpillRecordError`` while reading a generation: read it again once
      (a ``reread`` event), then rebuild the pass from ``fallback`` (the
      replayable source, or a one-shot run's generation 0; the pass's own
      filters make that wider read give the same bits; a ``rebuild``
      event). No fallback, or a failing one: it raises.
    - ``OSError(ENOSPC)`` while teeing: ``on_enospc`` raises
      SpillCapacityError or allows the pass to run again without its tee.
    - A transient error (``policy.retryable``): the whole pass runs again
      from the same source after the policy's backoff (a ``retry`` event
      under ``site``), ``policy.max_attempts`` times in all, then
      :class:`~mpi_k_selection_tpu_torch.errors.RetryExhaustedError`.

    Everything else propagates untouched. A terminal failure (exhaustion,
    spill damage with no rung left) dumps the flight recorder's bundle
    once first (obs/flight.py:``auto_dump``)."""
    transient = 0
    reread = False
    src = None
    tee = True
    while True:
        try:
            return run(src, tee)
        except SpillRecordError as e:
            if not reading_spill or src is not None:
                _fl.auto_dump(obs, "spill-unrecoverable", exc=e)
                raise
            if not reread:
                reread = True
                _emit_fault(obs, "spill.read", "reread", e)
                continue
            if fallback is None:
                _fl.auto_dump(obs, "spill-unrecoverable", exc=e)
                raise
            _emit_fault(obs, "spill.read", "rebuild", e)
            src = fallback
        except BaseException as e:
            # ENOSPC by its errno: ConnectionError and TimeoutError are
            # OSErrors too, and go on to the transient rung below
            if isinstance(e, OSError) and e.errno == errno.ENOSPC and tee and on_enospc is not None:
                on_enospc(e)  # raises SpillCapacityError unless the downgrade is allowed
                tee = False
                continue
            if policy is None or not policy.is_retryable(e):
                raise
            transient += 1
            if transient >= policy.max_attempts:
                exhausted = RetryExhaustedError(
                    f"{site}: still failing after {policy.max_attempts} attempts ({type(e).__name__}: {e})",
                    site=site, attempts=policy.max_attempts,
                )
                _fl.auto_dump(obs, "retry-exhausted", exc=exhausted)
                raise exhausted from e
            _emit_fault(obs, site, "retry", e)
            policy.sleep(transient)


def _resolve_spill(source, spill, spill_dir):
    """The ``spill`` knob against the source's replayability:
    ``(store, own_store, read_gen)``, where ``store`` is the SpillStore the
    descent tees into and reads back (None: the replay path), ``own_store``
    whether this call made it (and removes it on every exit), and
    ``read_gen`` a generation that serves pass 0 (the source is a store)."""
    spill = _sp.validate_spill_mode(spill)
    in_store = source if isinstance(source, _sp.SpillStore) else None
    read_gen = in_store.latest_generation() if in_store is not None else None
    if isinstance(spill, _sp.SpillStore):
        return spill, False, read_gen
    if spill == "force":
        return _sp.SpillStore(spill_dir), True, read_gen
    if spill == "auto":
        if in_store is not None:  # the source's own store serves the descent's generations too
            return in_store, False, read_gen
        if _is_one_shot_source(source):
            return _sp.SpillStore(spill_dir), True, None
    # "off", or "auto" with a replayable source: the replay path (a store
    # source still replays its newest generation every pass)
    return None, False, read_gen


def streaming_kselect(source, k, *, radix_bits: int = 8, collect_budget: int = DEFAULT_COLLECT_BUDGET,
                      sketch=None, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                      spill=DEFAULT_SPILL, spill_dir=None, width_schedule=DEFAULT_WIDTH_SCHEDULE,
                      pack_spill=DEFAULT_PACK_SPILL, device=None, devices=None, retry=None, timer=None, obs=None):
    """Exact k-th smallest (1-indexed) over a chunked stream: a host
    scalar of the stream's dtype (numpy; ml_dtypes' bfloat16 for
    bfloat16), bit for bit the JAX package's ``streaming_kselect``.

    ``source`` per :func:`as_chunk_source` (a one-shot iterator too, with
    ``spill`` on). ``radix_bits`` is the digit width of a pass (it must
    divide the key bits, or with a ``sketch`` the bits below its resolved
    prefix, under ``width_schedule="off"``); ``collect_budget`` bounds the
    survivors a rank collects to the host, and so the passes; ``sketch``
    (a RadixSketch of the same stream) seeds the descent;
    ``pipeline_depth`` (0 = synchronous), ``ingest_workers`` (None,
    ``"auto"`` or an int; checked only), ``spill`` (``"auto"``, ``"off"``,
    ``"force"`` or a SpillStore), ``spill_dir`` (the root of the stores a
    call makes; default the temp dir), ``width_schedule`` (``"off"``,
    ``"auto"`` or a tuple of widths), ``pack_spill`` (``"off"`` or
    ``"auto"``), ``device``, ``devices``, ``retry`` (None or
    ``"default"``, ``"off"``, or a RetryPolicy), ``timer`` and ``obs`` are
    described in the module docstring."""
    return streaming_kselect_many(
        source, [k], radix_bits=radix_bits, collect_budget=collect_budget, sketch=sketch,
        pipeline_depth=pipeline_depth, ingest_workers=ingest_workers, spill=spill, spill_dir=spill_dir,
        width_schedule=width_schedule, pack_spill=pack_spill, device=device, devices=devices, retry=retry,
        timer=timer, obs=obs,
    )[0]


def streaming_kselect_many(source, ks, *, radix_bits: int = 8, collect_budget: int = DEFAULT_COLLECT_BUDGET,
                           sketch=None, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                           spill=DEFAULT_SPILL, spill_dir=None, width_schedule=DEFAULT_WIDTH_SCHEDULE,
                           pack_spill=DEFAULT_PACK_SPILL, device=None, devices=None, retry=None, timer=None,
                           obs=None):
    """Exact k-th smallest for EVERY (1-indexed) rank in ``ks``, as a list
    in ``ks`` order, sharing each pass across ranks: the stream is read
    once per radix level plus one collect, not once per rank, with one
    histogram per DISTINCT surviving prefix at each level. With spill on,
    pass 0 tees the stream to the store and every later pass reads (and
    shrinks) the previous generation; ``store.pass_log`` records each
    pass (``store.pass_host_ms`` its host time in the record work). Knobs
    as :func:`streaming_kselect`."""
    width_schedule = validate_width_schedule(width_schedule)
    pack_spill = _sp.validate_pack_spill(pack_spill)
    depth = _pl.validate_pipeline_depth(pipeline_depth)
    pool_n = _pl.resolve_ingest_workers(ingest_workers)
    dev, devs = _pl.resolve_ingest(device, devices) if devices is not None else (None, (None,))
    policy = _fp.resolve_retry(retry)
    if not 1 <= radix_bits <= MAX_BITS:  # the JAX package's MAX_PASS_BITS
        raise ValueError(f"radix_bits={radix_bits} outside [1, {MAX_BITS}]")
    _wr.ingest_workers_gauge(obs, pool_n)
    ks = [int(k) for k in ks]
    if not ks:
        return []
    dev = _pl.resolve_device(device) if dev is None else dev
    # one bundle a slot in flight when the pipelined passes spread over slots
    multi = depth > 0 and devices is not None
    run = dict(pipeline_depth=depth, device=dev, devs=devs, window=len(devs) if multi else 1, retry=policy)
    timer, restore_recorder = _wr.attach_timer(obs, timer)
    run["timer"] = timer
    occupancy = _wr.window_occupancy(obs, phase="descent")
    store, own_store, read_gen = _resolve_spill(source, spill, spill_dir)
    one_shot = _is_one_shot_source(source)
    # ENOSPC degrades to the replay of the last good generation only when
    # the caller did not ask for spilling explicitly
    degrade_ok = isinstance(spill, str) and spill == "auto"
    spill_disabled = False
    created = []  # generations this call wrote: its cleanup set
    # the generation never dropped mid-descent: a caller-owned store's
    # pass-0 tee (kept for later calls), or a one-shot run's generation 0
    # (the only rebuild source a consumed stream has)
    protected = None
    n = 0

    def gen_src(filter_specs=None):
        # filter_specs prune the read of a v2 generation to the segments
        # that may hold matching keys (the consumers' own filters select)
        return read_gen.as_source(filter_specs=filter_specs) if read_gen is not None else src

    def fallback_src():
        """The rebuild source when the generation being read is corrupt:
        the replayable original, or a one-shot run's generation 0."""
        if not one_shot:
            return src
        if protected is not None and not protected.dropped:
            return protected.as_source()
        return None

    host_mark = {name: sw.seconds for name, sw in _sp.HOST_TIMES.items()}

    def log_pass(label, wrote=None, *, keys_read=None, read=None, disk_read=None):
        if store is None:
            return
        if read is None:
            read = "spill" if read_gen is not None else "source"
        if keys_read is None:
            keys_read = read_gen.keys if read_gen is not None else n
        # bytes_* are full-width key bytes, disk_bytes_* the physical ones
        # (smaller for v2 records; a source read's equal the key bytes)
        entry = {"pass": label, "read": read, "keys_read": int(keys_read), "bytes_read": int(keys_read) * kbytes,
                 "disk_bytes_read": int(keys_read) * kbytes if disk_read is None else int(disk_read)}
        if wrote is not None:
            entry.update(keys_written=int(wrote.keys), bytes_written=int(wrote.logical_nbytes),
                         disk_bytes_written=int(wrote.nbytes))
        store.pass_log.append(entry)
        host = {"pass": label}
        for name, sw in _sp.HOST_TIMES.items():
            host[f"{name}_ms"] = (sw.seconds - host_mark[name]) * 1e3
            host_mark[name] = sw.seconds
        store.pass_host_ms.append(host)

    def rotate(gen):
        """The just-committed generation becomes the next read; the one it
        replaces is dropped (at most two exist, plus the protected one)."""
        nonlocal read_gen
        created.append(gen)
        prev, read_gen = read_gen, gen
        if prev is not None and prev in created and prev is not protected:
            store.drop_generation(prev)
            created.remove(prev)

    def on_enospc(e):
        nonlocal spill_disabled
        if not degrade_ok:
            raise SpillCapacityError(
                "spill store out of disk while writing the next survivor generation; spilling was requested "
                f"explicitly (spill={spill!r}), so there is no silent fallback — free disk space, point "
                "spill_dir elsewhere, or run spill='auto'/'off'"
            ) from e
        spill_disabled = True
        _emit_fault(obs, "spill.write", "degrade", e)
        warnings.warn(
            "spill store out of disk (ENOSPC); degrading spill='auto' to the replay of the last good "
            "generation — spilling is disabled for the rest of this descent and later passes re-read that "
            "generation whole",
            RuntimeWarning,
            stacklevel=3,
        )

    def enospc_pass0(e):
        raise SpillCapacityError(
            "spill store out of disk while teeing generation 0 — no prior generation exists to degrade to; "
            "free disk space, point spill_dir elsewhere, or use spill='off' with a replayable source"
        ) from e

    try:
        src = as_chunk_source(source, one_shot_ok=store is not None)
        if policy is not None and not one_shot:
            # a mid-pass re-pull for a transient source error (a consumed
            # one-shot stream cannot be called again: its recovery is the
            # spill store's generation 0)
            src = _fp.resilient_source(src, policy, obs=obs)

        # per-rank descent state: [prefix, rebased k, resolved bits, population]
        if sketch is not None:
            # the sketch names the stream dtype (every chunk is held to it) and
            # resolves its top bits: the passes walk the bits below them
            dtype = _dt.torch_dtype(sketch.dtype)
            sketch.check_stream(dtype, radix_bits, width_schedule=width_schedule)
            # the passes walk the bits below the sketch's resolved prefix
            start_bits = sketch.resolution_bits
            schedule = resolve_width_schedule(width_schedule, _dt.key_bits(dtype), radix_bits, start_bits=start_bits)
            n = sketch.n
            _validate_ks(ks, n)
            states = [list(sketch.walk(k)) for k in ks]
            kbytes = _dt.key_bits(dtype) // 8
        else:
            start_bits = 0
            schedule = None
            pass0_gen = read_gen  # what pass 0 reads: a store source's generation, or None

            def first_pass(dtype):
                # pass 0 is also the length scan and the dtype probe: one
                # histogram of the first digit, no prefix filter; the
                # schedule resolves here, where the key bits are known
                nonlocal schedule
                total_bits = _dt.key_bits(dtype)
                schedule = resolve_width_schedule(width_schedule, total_bits, radix_bits)
                return _ex.FusedIngestConsumer(
                    total_bits=total_bits, hist=(total_bits - schedule[0], schedule[0], [None]), obs=obs
                )

            def pass0(src_override, tee):
                # with spill on, pass 0 also tees every chunk to generation 0,
                # segmented by each key's top digit under pack_spill="auto"
                writer = (store.new_generation(pack_digit_bits=_sp.GEN0_SEGMENT_BITS if pack_spill == "auto" else None)
                          if tee and store is not None and read_gen is None else None)
                try:
                    res = _stream_pass(
                        src_override if src_override is not None else gen_src(), None, first_pass,
                        spill=writer, obs=obs, label=0, phase="descent.pass", occupancy=occupancy, **run,
                    )
                    if res.consumer is None:
                        raise ValueError("streaming selection requires a non-empty stream")
                except BaseException:
                    if writer is not None:
                        writer.abort()
                    raise
                return res, writer.commit() if writer is not None else None

            # a one-shot source is consumed as it is teed: its pass 0
            # cannot run again (no transient rung), and fails typed with the
            # writer aborted
            res0, gen0 = _recover_pass(
                pass0, policy=None if one_shot else policy, reading_spill=read_gen is not None, fallback=None,
                on_enospc=enospc_pass0, obs=obs, site="pass 0",
            )
            dtype, n = res0.dtype, res0.n
            kbytes = _dt.key_bits(dtype) // 8
            if gen0 is not None:
                created.append(gen0)
                if not own_store or one_shot:
                    protected = gen0
            log_pass(0, gen0, disk_read=None if pass0_gen is None else pass0_gen.nbytes)
            if gen0 is not None:
                read_gen = gen0
            _validate_ks(ks, n)
            states = []
            hist0 = res0.consumer.hists[None]
            for k in ks:
                prefix, kk, pop = _np_walk(hist0, k, None, schedule[0])
                states.append([prefix, kk, schedule[0], pop])
            if obs is not None:
                if gen0 is not None:
                    _generation_event(obs, gen0)
                total0, max0, nz0 = _hist_summary({None: hist0})
                keys_read0 = int(pass0_gen.keys) if pass0_gen is not None else n
                obs.emit(_ev.StreamPassEvent(
                    pass_index=0, resolved_bits=0, prefixes=(), chunks=res0.chunks, keys_read=keys_read0,
                    bytes_read=keys_read0 * kbytes, read_from="spill" if pass0_gen is not None else "source",
                    bucket_total=total0, bucket_max=max0, bucket_nonzero=nz0,
                    survivors=tuple(int(st[3]) for st in states),
                    keys_written=None if gen0 is None else int(gen0.keys),
                    bytes_written=None if gen0 is None else int(gen0.logical_nbytes),
                    disk_bytes_read=int(pass0_gen.nbytes) if pass0_gen is not None else n * kbytes,
                    disk_bytes_written=None if gen0 is None else int(gen0.nbytes),
                ))
                _wr.resolved_bits_gauge(obs, 0, schedule[0])
        total_bits = _dt.key_bits(dtype)
        np_dtype = _np_dtype(dtype)
        # each schedule step's boundary -> (digit width, pass label): active
        # ranks advance in lockstep, so every pass starts on one; under
        # "off" the labels are the historical resolved // radix_bits
        steps = {}
        acc = start_bits
        for i, w in enumerate(schedule):
            steps[acc] = (w, start_bits // radix_bits + i)
            acc += w

        def active(st):
            return st[2] < total_bits and st[3] > collect_budget

        while any(active(st) for st in states):
            # active ranks advance in lockstep, so they sit at one depth: one
            # pass serves every distinct surviving prefix
            resolved = next(st[2] for st in states if active(st))
            width, label = steps[resolved]
            shift = total_bits - resolved - width
            prefixes = sorted({st[0] for st in states if active(st)})
            expected = {st[0]: st[3] for st in states if active(st)}
            tee_specs = None
            if store is not None and not spill_disabled:
                # the survivors this pass carries forward: the active
                # prefixes, and parked ranks (population within the budget)
                # still awaiting the collect, so the last generation serves
                # every collect spec
                tee_specs = sorted(
                    {(resolved, int(st[0])) for st in states if active(st)}
                    | {(st[2], int(st[0])) for st in states if not active(st) and st[2] < total_bits}
                )
            pass_read_gen = read_gen

            def run_pass(src_override, tee, shift=shift, width=width, prefixes=prefixes, expected=expected,
                         tee_specs=tee_specs, pass_read_gen=pass_read_gen):
                # under pack_spill="auto" the tee's own filter union is the
                # records' segment directory
                writer = (store.new_generation(pack_specs=tee_specs if pack_spill == "auto" else None,
                                               total_bits=total_bits)
                          if tee and tee_specs is not None else None)
                # what THIS attempt reads: the previous generation (or the
                # source), or the ladder's fallback
                read_from = ("spill" if (src_override is None and pass_read_gen is not None)
                             or (src_override is not None and one_shot) else "source")
                # the generation whose physical bytes this attempt reads (None:
                # a source read): the scheduled one, or a one-shot rebuild's gen 0
                disk_gen = pass_read_gen if src_override is None else (protected if one_shot else None)
                try:
                    res = _stream_pass(
                        src_override if src_override is not None else gen_src(tee_specs), dtype,
                        lambda _: _ex.FusedIngestConsumer(
                            total_bits=total_bits, hist=(shift, width, prefixes),
                            tee_specs=tee_specs if writer is not None else (), writer=writer, orig_dtype=np_dtype,
                            obs=obs,
                        ),
                        obs=obs, label=label, phase="descent.pass", occupancy=occupancy, **run,
                    )
                    consumer, pass_keys = res.consumer, res.n
                    hists = consumer.hists if consumer is not None else {p: np.zeros(1, np.int64) for p in prefixes}
                    for p in prefixes:
                        if int(hists[p].sum()) != expected[p]:
                            raise RuntimeError(
                                f"chunk source is not replay-stable: prefix {p:#x} holds "
                                f"{int(hists[p].sum())} elements this pass, previous pass "
                                f"counted {expected[p]}. The source callable must yield identical "
                                "data on every invocation."
                            )
                except BaseException:
                    if writer is not None:
                        writer.abort()
                    raise
                if disk_gen is None:
                    disk_read = pass_keys * kbytes
                elif src_override is None:  # the scheduled read, pruned to the tee's segments
                    disk_read = disk_gen.read_nbytes(tee_specs)
                else:
                    disk_read = disk_gen.nbytes
                gen = writer.commit() if writer is not None else None
                return hists, gen, pass_keys, res.chunks, read_from, disk_read

            hists, gen, pass_keys, pass_chunks, read_from, disk_read = _recover_pass(
                run_pass, policy=policy, reading_spill=read_gen is not None, fallback=fallback_src(),
                on_enospc=on_enospc, obs=obs, site=f"pass {label}",
            )
            log_pass(label, gen, keys_read=pass_keys, read=read_from, disk_read=disk_read)
            if gen is not None:
                rotate(gen)
            for st in states:
                if active(st):
                    st[0], st[1], st[3] = _np_walk(hists[st[0]], st[1], st[0], width)
                    st[2] = resolved + width
            if obs is not None:
                if gen is not None:
                    _generation_event(obs, gen)
                totalp, maxp, nzp = _hist_summary(hists)
                obs.emit(_ev.StreamPassEvent(
                    pass_index=label, resolved_bits=resolved, prefixes=tuple(int(p) for p in prefixes),
                    chunks=pass_chunks, keys_read=pass_keys, bytes_read=pass_keys * kbytes, read_from=read_from,
                    bucket_total=totalp, bucket_max=maxp, bucket_nonzero=nzp,
                    survivors=tuple(int(st[3]) for st in states),
                    keys_written=None if gen is None else int(gen.keys),
                    bytes_written=None if gen is None else int(gen.logical_nbytes),
                    disk_bytes_read=disk_read, disk_bytes_written=None if gen is None else int(gen.nbytes),
                ))
                _wr.resolved_bits_gauge(obs, label, resolved + width)

        specs = {(resolved, int(prefix)): pop for prefix, _, resolved, pop in states if resolved < total_bits}
        collected = {}
        if specs:

            def run_collect(src_override, tee):
                # what this attempt reads: the last generation pruned to the
                # collect's specs (or the source), or the ladder's fallback
                cspecs = tuple(specs)
                if src_override is None:
                    read_from = "spill" if read_gen is not None else "source"
                    kr = read_gen.read_keys(cspecs) if read_gen is not None else n
                    disk = read_gen.read_nbytes(cspecs) if read_gen is not None else kr * kbytes
                elif one_shot:
                    read_from, kr, disk = "spill", protected.keys, protected.nbytes
                else:
                    read_from, kr, disk = "source", n, n * kbytes
                out = _collect_survivors(src_override if src_override is not None else gen_src(cspecs), dtype,
                                         specs, run=run, staged=devices is not None, obs=obs, read_from=read_from,
                                         disk_bytes_read=disk)
                return out, read_from, kr, disk

            collected, read_from, keys_read, disk_read = _recover_pass(
                run_collect, policy=policy, reading_spill=read_gen is not None, fallback=fallback_src(),
                on_enospc=None, obs=obs, site="collect",
            )
            log_pass("collect", keys_read=keys_read, read=read_from, disk_read=disk_read)
        if obs is not None and obs.metrics is not None:
            # the run's counters while the store is open (the finally may
            # remove one the call made), and the process ledger
            _om.collect_runtime(obs.metrics, staging_pool=_pl.STAGING_POOL, spill_store=store, timer=timer)
            _ldg.collect_ledger(obs.metrics)
        kdt = _dt.np_to_sortable_bits(np.zeros(1, np_dtype)).dtype
        answers = []
        for prefix, kk, resolved, _ in states:
            if resolved == total_bits:  # every key bit resolved: the prefix IS the key
                key = prefix
            else:
                key = np.partition(collected[(resolved, int(prefix))], kk - 1)[kk - 1]
            answers.append(_dt.np_from_sortable_bits(np.asarray([key], kdt), np_dtype)[0])
        return answers
    finally:
        restore_recorder()
        if own_store:
            store.close()
        elif store is not None:
            # a caller-owned store keeps its pass-0 tee (it serves refine,
            # the certificate, the next call); the rest goes
            for g in created:
                if g is not protected and not g.dropped:
                    store.drop_generation(g)


def streaming_rank_certificate(source, value, *, pipeline_depth: int = DEFAULT_PIPELINE_DEPTH, ingest_workers=None,
                               width_schedule=DEFAULT_WIDTH_SCHEDULE, pack_spill=DEFAULT_PACK_SPILL, device=None,
                               devices=None, retry=None, timer=None, obs=None):
    """``(#elements < value, #elements <= value)`` over a chunked stream,
    as Python ints: an answer for rank k is exact iff ``less < k <= leq``.
    Compared in key space (ties, ``-0.0``/``+0.0`` and NaNs behave exactly
    as in the selection itself), on the card by the sweep kernel's
    certificate part. ``source`` may be a SpillStore with a committed
    generation: its newest is read from disk (a caller-owned store after a
    descent or a sketch tee holds its generation 0), so a one-shot
    stream's answer is certified without reading the stream again (a
    packed generation too). ``width_schedule`` and ``pack_spill`` are
    checked, as the JAX package checks them, and change nothing: one
    comparison pass has no digit to widen and writes no generation.
    ``devices`` spreads the pipelined pass over cards (each counts its own
    chunks), and ``obs`` records a ``certificate.pass`` event, as in
    :func:`streaming_kselect`. ``retry`` (None = the bounded default) gives
    the pass the mid-pass re-pull of a transient source error and the
    in-place retry of a chunk's staging; the counts are the same bits
    after a recovery."""
    validate_width_schedule(width_schedule)
    _sp.validate_pack_spill(pack_spill)
    depth = _pl.validate_pipeline_depth(pipeline_depth)
    pool_n = _pl.resolve_ingest_workers(ingest_workers)
    policy = _fp.resolve_retry(retry)
    src = as_chunk_source(source)
    if policy is not None:
        src = _fp.resilient_source(src, policy, obs=obs)
    dev, devs = _pl.resolve_ingest(device, devices)
    timer, restore_recorder = _wr.attach_timer(obs, timer)
    _wr.ingest_workers_gauge(obs, pool_n)
    # staging to slots is gated on the knobs as given, as the JAX package's
    staged = depth > 0 and devices is not None

    def certificate(dtype):
        # key the probe value in the stream's dtype, known at the first chunk
        return _ex.CountLessLeqConsumer(int(_dt.np_to_sortable_bits(np.asarray([value], _np_dtype(dtype)))[0]),
                                        obs=obs)

    try:
        res = _stream_pass(src, None, certificate, pipeline_depth=depth, device=dev, devs=devs, staged=staged,
                           window=len(devs) if staged else 1, obs=obs, label="certificate", timer=timer,
                           phase="certificate.pass", occupancy=_wr.window_occupancy(obs, phase="certificate"),
                           retry=policy)
    finally:
        restore_recorder()
    counter = res.consumer
    if counter is None:
        raise ValueError("streaming_rank_certificate requires a non-empty stream")
    if obs is not None:
        obs.emit(_ev.CertificateEvent(chunks=res.chunks, keys_read=res.n, less=counter.less, leq=counter.leq))
        if obs.metrics is not None:
            _om.collect_runtime(obs.metrics, staging_pool=_pl.STAGING_POOL, timer=timer)
    return counter.less, counter.leq
