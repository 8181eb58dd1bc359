"""RadixSketch: a fixed-size, exactly mergeable digit-histogram sketch for
online quantiles (counterpart of ``mpi_k_selection_tpu/streaming/sketch.py``).

Level ``l`` (1-indexed) is the exact histogram of the top ``l *
radix_bits`` key bits, for ``l = 1..levels``; the deepest level answers
queries, the shallower ones are its sums. Counts add elementwise, so
sketches of chunks, shards or processes merge with ``+`` in any order and
any tree shape, bit for bit. The accumulator is host int64 NumPy:
``sum(2^(l * radix_bits))`` counters, about 70K (0.5 MB) at the default 4
bits x 4 levels, whatever ``n``.

Guarantees (``b = resolution_bits = levels * radix_bits``):

- ``rank_bounds(k) -> (lo, hi)`` with ``lo < k <= hi``, exact for any
  stream: the true ranks of the resolved key interval's boundaries.
- ``value_bounds(k)`` brackets the true k-th value by that interval (width
  ``2^(key_bits - b)`` in key space, clamped to the observed extremes).
- ``query(k)`` / ``quantile(q)``: the interval's lower end, rank error at
  most ``rank_error_bound(k)`` (the bucket's population).
- ``refine(source, k)`` is exact: the streamed descent
  (streaming/chunked.py) starts below the sketch's resolved prefix,
  skipping its ``levels`` passes.

Where the counting runs. :meth:`RadixSketch.update_stream` stages every
chunk to the sketch's ``device`` (``"cuda"`` by default) and counts it with
the sweep kernel's sketch part (streaming/executor.py:
``SketchFoldConsumer``, one launch per chunk); :meth:`RadixSketch.update`
counts a CUDA tensor on its own device and stages anything else to the
sketch's device. ``device="cpu"`` runs the kernel's plain version. The JAX
package counts on the host unless it is given devices; the sketches are
the same bit for bit either way. :meth:`RadixSketch.update_value` is host
arithmetic on the pyramid.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import MAX_BITS
from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

# fixed-size cap: 2^20 int64 counters = 8 MB for the deepest level; the
# sweep kernel's widest sketch
_MAX_RESOLUTION_BITS = MAX_BITS

#: The JAX package's streaming knobs the port does not take: why each has
#: no counterpart.
LATER_KNOBS = {
    "fused": "no counterpart: the port has one route, the sweep kernel",
    "deferred": "no counterpart: the port has one executor discipline",
    "hist_method": "no counterpart: the histogram method follows the device (ops/histogram.py)",
}


def reject_later_knobs(where: str, kwargs: dict) -> None:
    """Raise Python's TypeError for the first keyword of ``kwargs``, saying
    why the port has no counterpart when it is a knob of the JAX package."""
    for name in kwargs:
        why = LATER_KNOBS.get(name)
        tail = f": {why}" if why else ""
        raise TypeError(f"{where}() got an unexpected keyword argument {name!r}{tail}")


def sketch_dtype(dtype) -> np.dtype:
    """The NumPy dtype of a stream (a torch or NumPy dtype, or a name;
    ml_dtypes' bfloat16 for bfloat16)."""
    return numpy_dtype(str(_dt.torch_dtype(dtype)).removeprefix("torch."))


class RadixSketch:
    """Mergeable multi-level radix-digit histogram over one dtype's
    streams. ``device`` is where :meth:`update_stream` and :meth:`update`
    count (default ``"cuda"``)."""

    def __init__(self, dtype, *, radix_bits: int = 4, levels: int = 4, device=None):
        self.dtype = sketch_dtype(dtype)  # validates dtype
        self.total_bits = _dt.key_bits(self.dtype)
        self.kdt = np.dtype(f"uint{self.total_bits}")
        if radix_bits < 1 or levels < 1:
            raise ValueError("radix_bits and levels must be >= 1")
        if levels * radix_bits > min(self.total_bits, _MAX_RESOLUTION_BITS):
            raise ValueError(
                f"levels*radix_bits={levels * radix_bits} exceeds "
                f"{min(self.total_bits, _MAX_RESOLUTION_BITS)} "
                f"(key bits capped at {_MAX_RESOLUTION_BITS} to keep the "
                "sketch fixed-size; refine() provides exactness beyond it)"
            )
        self.radix_bits = radix_bits
        self.levels = levels
        self.device = device
        self.n = 0
        self.hists = [np.zeros((1 << (l * radix_bits),), np.int64) for l in range(1, levels + 1)]
        # exact observed extremes, in key space (None until the first update)
        self._min_key = None
        self._max_key = None
        # memoized per-level CDFs: {level: (n, cumsum)}; every accumulation
        # grows n, so a stale entry never answers
        self._cdf_cache: dict = {}

    # -- accumulation ------------------------------------------------------

    @property
    def resolution_bits(self) -> int:
        """Key bits the deepest level resolves (= levels * radix_bits)."""
        return self.levels * self.radix_bits

    def _like(self) -> "RadixSketch":
        return RadixSketch(self.dtype, radix_bits=self.radix_bits, levels=self.levels, device=self.device)

    def update(self, chunk) -> "RadixSketch":
        """Fold one chunk in: a CUDA tensor counts on its own device, any
        other chunk (NumPy, a CPU tensor) on the sketch's device, with one
        launch of the sweep kernel. Returns ``self``; empty chunks are
        no-ops."""
        if isinstance(chunk, torch.Tensor):
            c = chunk.reshape(-1)
            name = str(c.dtype).removeprefix("torch.")
        else:
            c = np.ravel(np.asarray(chunk))
            name = str(c.dtype)
        if (c.numel() if isinstance(c, torch.Tensor) else c.size) == 0:
            return self
        if name != self.dtype.name:
            raise TypeError(f"chunk dtype {name} != sketch dtype {self.dtype}")
        on_card = isinstance(c, torch.Tensor) and c.is_cuda
        self._fold_stream(lambda: iter((c,)), 0, c.device if on_card else self.device)
        return self

    def update_stream(self, source, *, pipeline_depth=None, ingest_workers=None, spill=None, pack_spill=None,
                      devices=None, timer=None, obs=None, **kwargs) -> "RadixSketch":
        """Fold every chunk of ``source`` in (one pass; a list or tuple of
        chunks or a zero-arg callable, streaming/chunked.py:
        ``as_chunk_source``): chunks are staged to the sketch's device as
        the streamed descent stages them (``pipeline_depth``, None = 2;
        ``ingest_workers`` is checked only) and each is counted with one
        launch of the sweep kernel's sketch part, folded into the host
        int64 pyramid in chunk order. The same sketch, bit for bit, as
        :meth:`update` of each chunk in turn, at every depth.

        ``spill`` (a caller-owned streaming/spill.py ``SpillStore``) tees
        the same pass into a new generation of the store (a one-shot
        iterator is then accepted): afterwards ``refine(store, k)`` runs
        the exact descent from disk, never reading the stream again.
        ``pack_spill="auto"`` writes that generation in format v2,
        segmented by each key's top digit as the descent's pass 0 is, so a
        refine reads only the segments under its sketch buckets (None =
        ``"off"``: format v1). ``devices`` spreads the pipelined pass over
        cards (streaming/chunked.py), ``timer`` times its ``sketch.pass``
        and ``obs`` records its chunk events and one ``sketch.pass`` event.
        Returns ``self``."""
        reject_later_knobs("RadixSketch.update_stream", kwargs)
        from mpi_k_selection_tpu_torch.streaming import spill as _sp
        from mpi_k_selection_tpu_torch.streaming.chunked import as_chunk_source

        from mpi_k_selection_tpu_torch.obs import events as _ev
        from mpi_k_selection_tpu_torch.obs import metrics as _om
        from mpi_k_selection_tpu_torch.obs import wiring as _wr

        depth = _pl.validate_pipeline_depth(pipeline_depth)
        pack_spill = _sp.validate_pack_spill(pack_spill)
        pool_n = _pl.resolve_ingest_workers(ingest_workers)
        dev, devs = _pl.resolve_ingest(self.device, devices)
        timer, restore_recorder = _wr.attach_timer(obs, timer)
        # staging to slots is gated on the knobs as given, as the JAX package's
        staged = depth > 0 and devices is not None
        if spill is not None and not isinstance(spill, _sp.SpillStore):
            raise TypeError(
                "update_stream's spill must be a SpillStore (the caller owns its lifecycle), "
                f"got {type(spill).__name__!r}"
            )
        src = as_chunk_source(source, one_shot_ok=spill is not None)
        _wr.ingest_workers_gauge(obs, pool_n)
        writer = (spill.new_generation(pack_digit_bits=_sp.GEN0_SEGMENT_BITS if pack_spill == "auto" else None)
                  if spill is not None else None)
        try:
            res = self._fold_stream(src, depth, dev, spill=writer, devs=devs, staged=staged, obs=obs, timer=timer)
            if writer is not None:
                writer.commit()
        except BaseException:
            if writer is not None:
                writer.abort()
            raise
        finally:
            restore_recorder()
        if obs is not None:
            obs.emit(_ev.SketchPassEvent(chunks=res.chunks, keys_read=res.n, bytes_read=res.n * self.kdt.itemsize,
                                         staged_chunks=res.staged_chunks))
            if obs.metrics is not None:
                _om.collect_runtime(obs.metrics, staging_pool=_pl.STAGING_POOL, spill_store=spill, timer=timer)
        return self

    def _fold_stream(self, src, depth: int, device, spill=None, devs=(None,), staged=False, obs=None, timer=None):
        """One pass of ``src`` folded in on ``device`` (or the slots
        ``devs``); the pass's record (streaming/chunked.py:``_Pass``)."""
        from mpi_k_selection_tpu_torch.obs import wiring as _wr
        from mpi_k_selection_tpu_torch.streaming import chunked as _chunked
        from mpi_k_selection_tpu_torch.streaming.executor import SketchFoldConsumer

        return _chunked._stream_pass(
            src, _dt.torch_dtype(self.dtype), lambda _: SketchFoldConsumer(self, obs=obs),
            pipeline_depth=depth, device=_pl.resolve_device(device), devs=devs, staged=staged,
            window=len(devs) if staged else 1, spill=spill, obs=obs, label="sketch", timer=timer,
            phase="sketch.pass", occupancy=_wr.window_occupancy(obs, phase="sketch"),
        )

    def _fold_counts(self, deep: np.ndarray, kmin: int, kmax: int, n: int) -> None:
        """Fold one chunk's deepest-level int64 counts, its extremes (key
        values) and its count in."""
        self._fold_deep_histogram(deep)
        kmin, kmax = self.kdt.type(kmin), self.kdt.type(kmax)
        if self._min_key is None or kmin < self._min_key:
            self._min_key = kmin
        if self._max_key is None or kmax > self._max_key:
            self._max_key = kmax
        self.n += int(n)

    def _fold_deep_histogram(self, deep: np.ndarray) -> None:
        """Accumulate one deepest-level int64 histogram into every level
        (the shallower ones by reshape-sum: the same counts as counting
        the chunk again at the coarser width)."""
        self.hists[-1] += deep
        for l in range(1, self.levels):
            self.hists[l - 1] += deep.reshape(1 << (l * self.radix_bits), -1).sum(axis=1)

    def _check_compatible(self, other: "RadixSketch") -> None:
        if not isinstance(other, RadixSketch):
            raise TypeError(f"cannot merge RadixSketch with {type(other).__name__}")
        if self.dtype != other.dtype or self.radix_bits != other.radix_bits or self.levels != other.levels:
            raise ValueError(
                f"incompatible sketches: ({self.dtype}, rb={self.radix_bits}, "
                f"L={self.levels}) vs ({other.dtype}, rb={other.radix_bits}, "
                f"L={other.levels})"
            )

    def merge(self, other: "RadixSketch") -> "RadixSketch":
        """Elementwise-sum merge, associative and commutative: any merge
        tree over the same updates gives the same sketch bit for bit.
        Neither operand changes."""
        self._check_compatible(other)
        out = self._like()
        out.n = self.n + other.n
        out.hists = [a + b for a, b in zip(self.hists, other.hists)]
        mins = [s._min_key for s in (self, other) if s._min_key is not None]
        maxs = [s._max_key for s in (self, other) if s._max_key is not None]
        out._min_key = self.kdt.type(min(mins)) if mins else None
        out._max_key = self.kdt.type(max(maxs)) if maxs else None
        return out

    __add__ = merge

    def copy(self) -> "RadixSketch":
        """An independent deep copy (counts and extremes)."""
        out = self._like()
        out.n = self.n
        out.hists = [h.copy() for h in self.hists]
        out._min_key = self._min_key
        out._max_key = self._max_key
        return out

    def fold_scaled(self, other: "RadixSketch", weight: int) -> "RadixSketch":
        """In place: every count of ``other`` enters ``self`` times the
        non-negative integer ``weight`` (1: an in-place merge; larger: the
        fixed-point decay of monitor/decay.py). Each term is an exact int64
        product, so scaled folds stay associative and commutative. Refuses
        when ``other.n * weight`` could take the count past ``2^63 - 1``.
        Returns ``self``."""
        self._check_compatible(other)
        weight = int(weight)
        if weight < 0:
            raise ValueError(f"fold weight must be >= 0, got {weight}")
        if weight == 0 or other.n == 0:
            return self
        if other.n > ((1 << 63) - 1 - self.n) // weight:
            raise OverflowError(
                f"count-scaled fold of n={other.n} at weight={weight} would "
                f"overflow the int64 accumulator (current n={self.n}); lower "
                "DECAY_SHIFT or shorten the window"
            )
        for mine, theirs in zip(self.hists, other.hists):
            if weight == 1:
                mine += theirs
            else:
                mine += theirs * weight
        self.n += other.n * weight
        if other._min_key is not None and (self._min_key is None or other._min_key < self._min_key):
            self._min_key = self.kdt.type(other._min_key)
        if other._max_key is not None and (self._max_key is None or other._max_key > self._max_key):
            self._max_key = self.kdt.type(other._max_key)
        return self

    def update_value(self, value) -> "RadixSketch":
        """Fold ONE observation in with ``levels`` counter increments on the
        host: the same sketch as ``update([value])``."""
        key = _dt.np_to_sortable_bits(np.asarray([value], self.dtype))[0]
        deep = int(key >> self.kdt.type(self.total_bits - self.resolution_bits))
        for l in range(1, self.levels + 1):
            self.hists[l - 1][deep >> ((self.levels - l) * self.radix_bits)] += 1
        if self._min_key is None or key < self._min_key:
            self._min_key = self.kdt.type(key)
        if self._max_key is None or key > self._max_key:
            self._max_key = self.kdt.type(key)
        self.n += 1
        return self

    def __eq__(self, other) -> bool:
        if not isinstance(other, RadixSketch):
            return NotImplemented
        return (
            self.dtype == other.dtype
            and self.radix_bits == other.radix_bits
            and self.levels == other.levels
            and self.n == other.n
            and self._min_key == other._min_key
            and self._max_key == other._max_key
            and all(np.array_equal(a, b) for a, b in zip(self.hists, other.hists))
        )

    __hash__ = None  # mutable accumulator

    # -- queries -----------------------------------------------------------

    def _bucket(self, k: int, level: int | None = None):
        """(bucket, rank_lo, rank_hi) at ``level`` (deepest by default):
        the bucket whose exact rank interval holds k; the level's CDF is
        memoized until the next accumulation."""
        if self.n == 0:
            raise ValueError("empty sketch")
        k = int(k)
        if not 1 <= k <= self.n:
            raise ValueError(f"k={k} out of range [1, {self.n}]")
        lvl = self.levels if level is None else level
        cached = self._cdf_cache.get(lvl)
        if cached is not None and cached[0] == self.n:
            cum = cached[1]
        else:
            cum = np.cumsum(self.hists[lvl - 1])
            self._cdf_cache[lvl] = (self.n, cum)
        b = int(np.searchsorted(cum, k, side="left"))
        lo = int(cum[b - 1]) if b else 0
        return b, lo, int(cum[b])

    def rank_bounds(self, k: int) -> tuple[int, int]:
        """Exact ``(lo, hi)`` with ``lo < k <= hi``: the true ranks
        bracketing the resolved key interval that holds the k-th
        smallest. Holds for any stream."""
        _, lo, hi = self._bucket(k)
        return lo, hi

    def rank_error_bound(self, k: int) -> int:
        """Worst-case rank error of :meth:`query` for this k: the
        answering bucket's population."""
        lo, hi = self.rank_bounds(k)
        return hi - lo

    def max_bucket_population(self) -> int:
        """The heaviest deepest-level bucket: the sketch-wide rank-error
        bound."""
        return int(self.hists[-1].max()) if self.n else 0

    def _interval_keys(self, bucket: int):
        shift = self.total_bits - self.resolution_bits
        lo_key = self.kdt.type(np.uint64(bucket) << np.uint64(shift))
        span = (np.uint64(1) << np.uint64(shift)) - np.uint64(1)
        hi_key = self.kdt.type((np.uint64(bucket) << np.uint64(shift)) | span)
        lo_key = max(lo_key, self._min_key)
        hi_key = min(hi_key, self._max_key)
        return lo_key, hi_key

    def value_bounds(self, k: int):
        """``(v_lo, v_hi)`` values of the stream's dtype with the true k-th
        smallest inside: the resolved key interval clamped to the observed
        extremes. Exact for any stream."""
        b, _, _ = self._bucket(k)
        lo_key, hi_key = self._interval_keys(b)
        pair = _dt.np_from_sortable_bits(np.asarray([lo_key, hi_key], self.kdt), self.dtype)
        return pair[0], pair[1]

    def query(self, k: int):
        """Point estimate for the k-th smallest: the answering interval's
        lower end (clamped to the extremes); rank error bounded by
        :meth:`rank_error_bound`; :meth:`refine` for the exact answer."""
        return self.value_bounds(k)[0]

    def describe(self, k: int):
        """``(rank_lo, rank_hi, v_lo, v_hi, pinned)`` from one bucket
        resolution: :meth:`rank_bounds`, :meth:`value_bounds` and
        :meth:`pin` at once."""
        b, lo, hi = self._bucket(k)
        lo_key, hi_key = self._interval_keys(b)
        pair = _dt.np_from_sortable_bits(np.asarray([lo_key, hi_key], self.kdt), self.dtype)
        pinned = pair[0] if lo_key == hi_key else None
        return lo, hi, pair[0], pair[1], pinned

    def pin(self, k: int):
        """The exact k-th smallest when the answering interval, clamped to
        the extremes, is a single key (the resolution covers the key, the
        data concentrates, or k sits at an extreme), else None."""
        b, _, _ = self._bucket(k)
        lo_key, hi_key = self._interval_keys(b)
        if lo_key != hi_key:
            return None
        return _dt.np_from_sortable_bits(np.asarray([lo_key], self.kdt), self.dtype)[0]

    def quantile(self, q: float):
        """Approximate quantile (nearest rank, as api.quantile_ranks)."""
        return self.quantiles([q])[0]

    def quantiles(self, qs):
        from mpi_k_selection_tpu_torch.api import quantile_ranks

        return [self.query(k) for k in quantile_ranks(qs, self.n)]

    # -- exact refinement --------------------------------------------------

    def walk(self, k: int):
        """``(prefix, rebased_k, resolved_bits, population)`` of the
        deepest level: the seed of a streamed descent, the state that
        ``resolution_bits / radix_bits`` streamed passes would reach."""
        b, lo, hi = self._bucket(k)
        return b, int(k) - lo, self.resolution_bits, hi - lo

    def check_stream(self, dtype, radix_bits: int, width_schedule="off") -> None:
        """Check that a streamed descent of ``radix_bits`` digits over a
        stream of ``dtype`` can continue from this sketch's prefix. Under
        another ``width_schedule`` than ``"off"`` only the dtype is
        checked: the schedule itself must cover the bits below the prefix
        (streaming/chunked.py: ``resolve_width_schedule``)."""
        if sketch_dtype(dtype) != self.dtype:
            raise TypeError(f"stream dtype {sketch_dtype(dtype)} != sketch dtype {self.dtype}")
        if width_schedule != "off":
            return
        remaining = self.total_bits - self.resolution_bits
        if remaining % radix_bits:
            raise ValueError(
                f"radix_bits={radix_bits} must divide the {remaining} key "
                f"bits left below the sketch's {self.resolution_bits} "
                "resolved bits"
            )

    def refine(self, source, k: int, **kwargs):
        """Exact k-th smallest over ``source``, which must replay the
        stream this sketch accumulated: the descent starts below the
        sketch's prefix. Keywords are streaming/chunked.py:
        ``streaming_kselect``'s (``radix_bits`` defaults to the sketch's,
        ``device`` to its device)."""
        from mpi_k_selection_tpu_torch.streaming.chunked import streaming_kselect

        kwargs.setdefault("radix_bits", self.radix_bits)
        kwargs.setdefault("device", self.device)
        return streaming_kselect(source, k, sketch=self, **kwargs)

    def refine_many(self, source, ks, **kwargs):
        """Exact k-th smallest for every rank in ``ks`` over ``source``
        (the same stream), from one sketch-seeded descent that shares its
        passes; answers in ``ks`` order. Keywords as :meth:`refine`."""
        from mpi_k_selection_tpu_torch.streaming.chunked import streaming_kselect_many

        kwargs.setdefault("radix_bits", self.radix_bits)
        kwargs.setdefault("device", self.device)
        return streaming_kselect_many(source, ks, sketch=self, **kwargs)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RadixSketch(dtype={self.dtype}, radix_bits={self.radix_bits}, "
            f"levels={self.levels}, n={self.n}, "
            f"resolution_bits={self.resolution_bits})"
        )
