"""High-level selection API (counterpart of ``mpi_k_selection_tpu/api.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` or a CPU tensor. ``obs`` (obs/:``Observability``) on
:func:`kselect` and :func:`kselect_many` records each resolved dispatch as
one ``resident.select`` event; every call reports to the process ledger's
``api.select`` site under the JAX package's key.

Each entry point is one span (utils/profiling.py:``span``): ``ksel.kselect``,
``ksel.kselect_many`` and ``ksel.quantiles`` (around its ranks and the
``ksel.kselect_many`` it calls), so a call of a closed loop is one entry
span in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from mpi_k_selection_tpu_torch.obs import ledger as _ldg
from mpi_k_selection_tpu_torch.obs.events import ResidentSelectEvent
from mpi_k_selection_tpu_torch.ops.radix import radix_select, radix_select_many
from mpi_k_selection_tpu_torch.ops.sort import sort_order_keys, sort_select
from mpi_k_selection_tpu_torch.streaming import chunked as _chunked
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.debug import check_concrete_k, check_concrete_ks
from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy
from mpi_k_selection_tpu_torch.utils.profiling import span

ALGORITHMS = ("auto", "radix", "sort")


def as_selection_array(x, device=None) -> torch.Tensor:
    """A selection input as a torch tensor: a tensor stays where it is (or
    moves to ``device`` when one is given); anything else goes through
    NumPy, bit for bit, to ``device`` (default ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return tensor_from_numpy(np.asarray(x), "cuda" if device is None else device)


def resolve_algorithm(algorithm: str, n: int) -> str:
    """The algorithm a selection of ``n`` elements runs: ``"auto"`` takes
    sort for small inputs (it is competitive only there; radix is O(n) per
    pass), an explicit name is checked and kept."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; choose from {ALGORITHMS}")
    if algorithm == "auto":
        return "sort" if n <= 1 << 14 else "radix"
    return algorithm


def many_sort_dispatch_queries(n: int) -> int:
    """Query count at and above which :func:`kselect_many` sorts once and
    gathers instead of running the shared radix walk: ``13*log2(n) - 230``,
    clamped to [64, 192]. The walk costs about one read per pass whatever
    K (the multi-prefix kernel does one prefix lookup per key), then a
    collect whose work grows with K; the sort about ``n log n``, so the
    crossover grows with ``log2(n)``. The rule is the JAX package's, fitted
    on its own device, and kept here: which leg runs decides the answers'
    order for +-0.0 and NaN (:func:`many_takes_sort`). ``chip_smoke.py``
    times both legs on the card at K = 4, 64 and 128."""
    return int(min(192, max(64, round(13 * math.log2(max(n, 2)) - 230))))


def many_takes_sort(n: int, n_queries: int) -> bool:
    """Whether :func:`kselect_many` of ``n_queries`` ranks over ``n``
    elements sorts once and gathers (and so answers in ``lax.sort``'s
    order, ops/sort.py) rather than walking the radix digits."""
    return n <= 1 << 14 or n_queries >= many_sort_dispatch_queries(n)


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).removeprefix("torch.")


def kselect(x, k, *, algorithm: str = "auto", device=None, obs=None, **kwargs) -> torch.Tensor:
    """Exact k-th smallest element (1-indexed k, reference semantics:
    ``kth-problem-seq.c:32-33``), a 0-d tensor on the input's device.
    Like the JAX package's, the sort path (small inputs) answers in
    ``lax.sort``'s order and the radix path in the sortable keys' order
    (ops/sort.py). ``obs`` records the dispatch (see the module
    docstring). ``kwargs`` go to
    :func:`~mpi_k_selection_tpu_torch.ops.radix.radix_select`
    (``radix_bits``, ``early_exit_budget``, ``cutover``,
    ``cutover_budget``); the sort path ignores them."""
    with span("ksel.kselect"):
        x = as_selection_array(x, device)
        if x.numel() == 0:
            raise ValueError("kselect requires a non-empty input")
        check_concrete_k(k, x.numel())
        algorithm = resolve_algorithm(algorithm, x.numel())
        if obs is not None:
            obs.emit(ResidentSelectEvent(n=x.numel(), queries=1, algorithm=algorithm, dtype=_dtype_name(x)))
        with _ldg.ledger_dispatch("api.select", (x.numel(), _dtype_name(x), algorithm, 1), obs):
            if algorithm == "radix":
                return radix_select(x, k, **kwargs)
            return sort_select(x, k)


def kselect_many(x, ks, *, device=None, obs=None, **kwargs) -> torch.Tensor:
    """Exact k-th smallest for every (1-indexed) k in ``ks`` over one array,
    in ``ks`` order and with ``ks``'s shape (a scalar k returns a 0-d
    tensor, as :func:`kselect` does).

    Small inputs (n <= 2^14) and many queries (K >=
    :func:`many_sort_dispatch_queries`) sort once and gather; otherwise the
    radix walk shares every pass across the queries
    (:func:`~mpi_k_selection_tpu_torch.ops.radix.radix_select_many`, which
    ``kwargs`` go to). ``obs`` records the dispatch (``sort-many`` or
    ``radix-many``, and the query count) as :func:`kselect` does."""
    with span("ksel.kselect_many"):
        x = as_selection_array(x, device)
        n = x.numel()
        if n == 0:
            raise ValueError("kselect_many requires a non-empty input")
        check_concrete_ks(ks, n)
        n_queries = ks.numel() if isinstance(ks, torch.Tensor) else int(np.size(ks))
        use_sort = many_takes_sort(n, n_queries)
        algorithm = "sort-many" if use_sort else "radix-many"
        if obs is not None:
            obs.emit(ResidentSelectEvent(n=n, queries=n_queries, algorithm=algorithm, dtype=_dtype_name(x)))
        with _ldg.ledger_dispatch("api.select", (n, _dtype_name(x), algorithm, n_queries), obs):
            if use_sort:
                if kwargs:
                    warnings.warn(
                        f"kselect_many: this shape takes the sort path (small input or "
                        f">= {many_sort_dispatch_queries(n)} queries at this n); radix options "
                        f"{sorted(kwargs)} are ignored",
                        stacklevel=2,
                    )
                out = sort_select(x, ks)
            else:
                out = radix_select_many(x, ks, **kwargs)
        return restore_k_shape(out, ks)


def quantile_ranks(qs, n: int) -> list[int]:
    """Nearest-rank 1-indexed ks for quantiles ``qs`` over ``n`` elements:
    ``k = max(1, ceil(q * n))``, computed in float64 on the host (a float32
    round trip perturbs q, 0.99 -> 0.99000001, enough to move
    ``ceil(q * n)`` by one rank)."""
    qs_list = [float(q) for q in np.atleast_1d(np.asarray(qs, dtype=np.float64))]
    for q in qs_list:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
    return [max(1, min(n, math.ceil(q * n))) for q in qs_list]


def quantile_ks(qs, n: int, device) -> torch.Tensor:
    """:func:`quantile_ranks` as an int64 tensor on ``device``."""
    return torch.tensor(quantile_ranks(qs, n), dtype=torch.int64, device=device)


def restore_k_shape(out: torch.Tensor, ks) -> torch.Tensor:
    """Shape contract of the ``*_many`` entry points: answers carry
    ``ks``'s shape, so a scalar k returns a 0-d tensor."""
    if isinstance(ks, (list, tuple)):
        return out  # a container is a 1-D list of queries
    ndim = ks.dim() if isinstance(ks, torch.Tensor) else np.ndim(ks)
    return out.reshape(()) if ndim == 0 else out


def quantiles(x, qs, *, device=None, **kwargs) -> torch.Tensor:
    """Exact order statistics at quantiles ``qs`` (nearest rank: every
    answer is an element of ``x``), a (len(qs),) tensor on the input's
    device. One ``ksel.quantiles`` span holds the ranks' computation and
    the ``ksel.kselect_many`` span of the selection."""
    with span("ksel.quantiles"):
        x = as_selection_array(x, device)
        if x.numel() == 0:
            raise ValueError("quantiles requires a non-empty input")
        return kselect_many(x, quantile_ks(qs, x.numel(), x.device), **kwargs)


def median(x, *, device=None, **kwargs) -> torch.Tensor:
    """Lower median: k = max(1, n//2), the reference's median operating
    point."""
    x = as_selection_array(x, device)
    return kselect(x, max(1, x.numel() // 2), **kwargs)


def batched_kselect(x, k, *, device=None) -> torch.Tensor:
    """Per-row exact k-th smallest along the last axis (1-indexed k), in
    ``jnp.sort``'s order as the JAX package's ``batched_kselect``: a stable
    sort of each row (ops/sort.py:sort_order_keys), then a gather of the
    original element, bit for bit.

    ``k`` is a scalar or broadcastable to the batch shape ``x.shape[:-1]``
    (one rank per row). A host scalar k outside [1, d] raises; an array k
    is clamped to [1, d]."""
    x = as_selection_array(x, device)
    if x.dim() < 2:
        raise ValueError("batched_kselect wants a (..., d) batch; use kselect for 1-D")
    d = x.shape[-1]
    check_concrete_k(k, d)
    order = torch.sort(sort_order_keys(x), dim=-1, stable=True).indices
    kk = torch.as_tensor(k, device=x.device).to(torch.int64)
    pos = order.gather(-1, torch.broadcast_to((kk - 1).clamp(0, d - 1), x.shape[:-1])[..., None])
    # through the signed view: CUDA has no index kernel for uint16/32/64
    return _dt.bit_view(x).gather(-1, pos)[..., 0].view(x.dtype)


def batched_median(x, *, device=None) -> torch.Tensor:
    """Per-row lower median along the last axis: k = max(1, d // 2)."""
    x = as_selection_array(x, device)
    d = x.shape[-1] if x.dim() else 0
    return batched_kselect(x, max(1, d // 2))


# selection over chunk sources that never lie whole on one device
# (streaming/chunked.py; the JAX package's ``kselect_streaming``)
kselect_streaming = _chunked.streaming_kselect
kselect_streaming_many = _chunked.streaming_kselect_many
streaming_rank_certificate = _chunked.streaming_rank_certificate


class StreamingQuantiles:
    """Online quantiles over a chunked stream: a mergeable
    :class:`~mpi_k_selection_tpu_torch.streaming.sketch.RadixSketch` and
    its exact refinement. Feed chunks as they arrive (``update``,
    ``update_stream``), merge trackers of other shards or processes in any
    order (``merge``: the same bits whatever the order), read approximate
    quantiles at any time (``quantiles``: rank error within the sketch's
    bounds), and spend passes over a replayable source only for exact
    answers (``refine_quantiles``).

    ``pipeline_depth`` governs the staging of ``update_stream`` and of
    the refinement passes (streaming/pipeline.py; ``ingest_workers`` > 1
    runs their pooled host data plane), and ``device`` where they count (default
    ``"cuda"``; ``"cpu"`` runs the kernel's plain version); ``devices``
    spreads that ingest over cards (streaming/chunked.py) and ``obs``
    records it (checked now, kept for every pass).
    ``width_schedule`` (None = ``"off"``) sets the refinement's digit
    widths and ``pack_spill`` (None = ``"off"``) the format of the
    ``update_stream`` tee and of the refinement's generations
    (streaming/chunked.py); both are checked here. The JAX package's
    ``deferred`` and ``fused`` have no counterpart here. The spill flow of
    a one-shot stream: ``update_stream(it, spill=store)``, then
    ``refine_quantiles(qs, store)``."""

    def __init__(self, dtype, *, radix_bits: int = 4, levels: int = 4, pipeline_depth: int | None = None,
                 width_schedule=None, pack_spill=None, ingest_workers=None, device=None, devices=None, obs=None,
                 **kwargs):
        from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
        from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch, reject_later_knobs
        from mpi_k_selection_tpu_torch.streaming.spill import validate_pack_spill

        reject_later_knobs("StreamingQuantiles.__init__", kwargs)
        self.pipeline_depth = _pl.validate_pipeline_depth(pipeline_depth)
        if devices is not None:
            _pl.resolve_ingest(device, devices)  # checked now, like depth
        self.devices = devices
        self.obs = obs
        self.width_schedule = _chunked.DEFAULT_WIDTH_SCHEDULE if width_schedule is None else width_schedule
        _chunked.validate_width_schedule(self.width_schedule)  # checked now
        self.pack_spill = validate_pack_spill(pack_spill)
        _pl.resolve_ingest_workers(ingest_workers)  # checked now
        self.ingest_workers = ingest_workers
        self.device = device
        self.sketch = RadixSketch(dtype, radix_bits=radix_bits, levels=levels, device=device)

    @property
    def n(self) -> int:
        return self.sketch.n

    def update(self, chunk) -> "StreamingQuantiles":
        self.sketch.update(chunk)
        return self

    def update_stream(self, source, *, spill=None) -> "StreamingQuantiles":
        """Fold every chunk of ``source`` in, one launch of the sweep
        kernel per chunk on the tracker's device (or its ``devices``):
        the same sketch as ``update`` of each chunk in turn. ``spill`` (a
        caller-owned SpillStore) tees the pass into the store, which makes
        a one-shot source refinable: pass the store to
        :meth:`refine_quantiles`. The tracker's ``pack_spill`` sets the
        tee's format."""
        self.sketch.update_stream(
            source, pipeline_depth=self.pipeline_depth, ingest_workers=self.ingest_workers, spill=spill,
            pack_spill=self.pack_spill, devices=self.devices, obs=self.obs,
        )
        return self

    def merge(self, other) -> "StreamingQuantiles":
        out = StreamingQuantiles(
            self.sketch.dtype, radix_bits=self.sketch.radix_bits, levels=self.sketch.levels,
            pipeline_depth=self.pipeline_depth, width_schedule=self.width_schedule, pack_spill=self.pack_spill,
            ingest_workers=self.ingest_workers, device=self.device, devices=self.devices, obs=self.obs,
        )
        out.sketch = self.sketch.merge(other.sketch if isinstance(other, StreamingQuantiles) else other)
        return out

    def quantiles(self, qs):
        """Approximate nearest-rank quantile values (RadixSketch.query's
        error contract)."""
        return self.sketch.quantiles(qs)

    def refine_quantiles(self, qs, source):
        """Exact nearest-rank quantiles over ``source``, which must replay
        the stream this tracker accumulated (or be the SpillStore its
        ``update_stream`` teed into): one sketch-seeded descent shares
        every pass across the ranks."""
        return _chunked.streaming_kselect_many(
            source, quantile_ranks(qs, self.sketch.n), radix_bits=self.sketch.radix_bits, sketch=self.sketch,
            pipeline_depth=self.pipeline_depth, width_schedule=self.width_schedule, pack_spill=self.pack_spill,
            ingest_workers=self.ingest_workers, device=self.device, devices=self.devices, obs=self.obs,
        )
