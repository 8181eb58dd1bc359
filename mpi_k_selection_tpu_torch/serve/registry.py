"""Dataset registry and keyed program cache: the resident state of the
query server (counterpart of ``mpi_k_selection_tpu/serve/registry.py``).

- :class:`ResidentDataset`: one registered dataset, an immutable resident
  tensor on the device named at registration (``residency="device"``) or a
  replayable chunk source (``"stream"``), with an optional resident
  :class:`~mpi_k_selection_tpu_torch.streaming.sketch.RadixSketch` for the
  sketch and auto tiers.
- :class:`DatasetRegistry`: the id -> dataset map (one lock, listings
  copied on read) and the selection dispatch the lanes' threads call
  (:meth:`DatasetRegistry.select_many`, :meth:`topk`,
  :meth:`rank_certificate`).
- :class:`ProgramCache`: a keyed LRU cache (hit and miss counters) of the
  built selection programs and their state: each dataset's walk closure
  and its cached full sort, in ``lax.sort``'s order (one sort serves every
  later sort-path batch as a gather). PyTorch compiles nothing per shape,
  so a "compile" here is a first build: the lazy ``nvcc`` build of a
  kernel source and the first launch of each kernel the program runs
  (ops/cuda/build.py). Every build runs under the ledger's
  ``serve.programs`` compile span; a warmed dataset books none on the
  request path.

Residency. The JAX package keeps caller-typed 64-bit integers without x64
as a one-chunk stream and float64 on the host for its TPU; the port has
neither restriction, so every array is ``"device"`` residency, on the
device the caller names (``"cuda"`` by default: without a card the
registration raises), and every chunk source is ``"stream"``. The ledger's
``resident`` byte book keeps the JAX package's three residency labels.

Immutability. A torch tensor can change under its owner's hands; a
registration clones whatever the conversion did not copy (a tensor
already on the target device, or any array placed on the CPU, which
shares the caller's memory), so a caller mutating its array afterwards
never changes a served answer. The clone is the resident byte count.

Concurrency: datasets are immutable once registered, the dict is guarded
by one lock, and each dataset's device work runs on its dispatch lane's
thread (serve/lanes.py); the registry starts no thread. Builds run behind a
per-key latch, so two lanes racing a first query build a program once.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from mpi_k_selection_tpu_torch.obs import ledger as _ldg
from mpi_k_selection_tpu_torch.serve.errors import (
    DatasetExistsError,
    DatasetNotFoundError,
    QueryError,
    ServerClosedError,
)
from mpi_k_selection_tpu_torch.utils.dtypes import bit_view
from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

#: Default resident-sketch geometry (the RadixSketch defaults).
DEFAULT_SKETCH_BITS = 4
DEFAULT_SKETCH_LEVELS = 4

#: Keys a view of a resident tensor folds into its sketch at a time: one
#: streamed chunk, the size the sweep kernel's launches are laid out for.
#: The pyramid is the same bits at any view size.
SKETCH_VIEW = 1 << 26

#: The JAX package's stream knobs the port has no counterpart for,
#: refused at registration (streaming/sketch.py:LATER_KNOBS says why).
REFUSED_STREAM_KNOBS = ("fused", "deferred", "hist_method")


class ProgramCache:
    """Keyed LRU cache of built programs and their state, with plain int
    ``hits`` / ``misses`` under the lock (the server mirrors them into the
    metrics registry)."""

    #: ProgramLedger site this cache reports into (obs/ledger.py): hits as
    #: cache hits, builds as compiles with their wall clocked.
    LEDGER_SITE = "serve.programs"

    def __init__(self, *, max_entries: int = 64):
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()  # ksel: guarded-by[_lock]
        #: per-key build latches: key -> Event set when that build ends
        #: (success or failure)
        self._building: dict = {}  # ksel: guarded-by[_lock]
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        #: optional Observability whose sink receives RecompileStormEvents
        #: (set by KSelectServer; the ledger books the builds either way)
        self.obs = None

    def get_or_build(self, key, builder):
        """The cached value of ``key``, built (and cached) on the first
        request. The build runs outside the lock behind a per-key latch:
        the first caller builds, concurrent callers of the same key wait
        on the latch and take the finished value as a hit (one build, one
        ledger entry). A build that raises caches nothing; its waiters
        retry the build themselves."""
        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    value = self._entries[key]
                    latch = None
                else:
                    latch = self._building.get(key)
                    if latch is None:
                        self.misses += 1
                        self._building[key] = threading.Event()
                        break
            if latch is None:  # the ledger locks itself: outside ours
                _ldg.LEDGER.note_hit(self.LEDGER_SITE, key)
                return value
            # another thread builds this key: re-enter after its latch (a
            # hit, or a rebuild when the build failed or was evicted)
            latch.wait()
        try:
            with _ldg.LEDGER.compile_span(self.LEDGER_SITE, key, obs=self.obs):
                value = builder()
        except BaseException:
            with self._lock:
                self._building.pop(key).set()
            raise
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            # waiters re-enter only once the entry is visible: a clean hit
            self._building.pop(key).set()
        return value

    def drop_dataset(self, dataset_id: str) -> None:
        """Evict every entry of one dataset (keys are ``(kind, dataset_id,
        ...)``), releasing its cached sort and walk closure."""
        with self._lock:
            for key in [k for k in self._entries if k[1] == dataset_id]:
                del self._entries[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclasses.dataclass(frozen=True)
class ResidentDataset:
    """One registered dataset. ``residency`` is ``"device"`` (``data``, a
    1-D tensor on ``device``) or ``"stream"`` (``source``, a replayable
    chunk source counted on ``device``; exact queries run the streamed
    descent). ``sketch`` is the resident RadixSketch (None: the exact tier
    only). ``device`` is the device named at registration, as a string
    (``"cuda:0"``, ``"cpu"``, ``"cpu:1"``): the lane key of a device
    dataset, never read back from the tensor (a ``cpu:1`` tensor reports
    ``cpu``)."""

    dataset_id: str
    residency: str
    dtype: object  # np.dtype (ml_dtypes' bfloat16 for bfloat16)
    n: int
    data: object = None
    source: object = None
    sketch: object = None
    stream_kwargs: dict = dataclasses.field(default_factory=dict)
    device: str | None = None

    @property
    def nbytes(self) -> int:
        """Resident bytes of the dataset's data (0 for a stream): the
        figure the ledger's ``resident`` book adds up."""
        if self.data is None:
            return 0
        return int(self.n) * np.dtype(self.dtype).itemsize

    def summary(self) -> dict:
        """JSON-ready description (a row of the /v1/datasets listing)."""
        out = {
            "dataset": self.dataset_id,
            "residency": self.residency,
            "dtype": str(np.dtype(self.dtype)),
            "n": self.n,
            "resident_bytes": self.nbytes,
            "sketch": self.sketch is not None,
        }
        if self.sketch is not None:
            out["sketch_resolution_bits"] = self.sketch.resolution_bits
            out["sketch_max_bucket"] = self.sketch.max_bucket_population()
        return out


def _recorded_device(x: torch.Tensor, device) -> str:
    """The device a registration names: a card with its index (the
    tensor's), or the CPU slot as given (``cpu:1`` stays ``cpu:1``)."""
    if device is None or torch.device(device).type == "cuda":
        return str(x.device)
    return str(torch.device(device))


class DatasetRegistry:
    """Id-keyed home of the resident datasets, and the program cache."""

    def __init__(self, *, programs: ProgramCache | None = None):
        self._lock = threading.Lock()
        self._datasets: dict[str, ResidentDataset] = {}  # ksel: guarded-by[_lock]
        self._closed = False  # ksel: guarded-by[_lock]
        self.programs = programs if programs is not None else ProgramCache()

    # -- lifecycle ---------------------------------------------------------

    def _check_new_id(self, dataset_id: str) -> None:
        """The duplicate check before the costly registration work (the
        copy to the device, the sketch pass); :meth:`_register`'s locked
        check still closes the race."""
        with self._lock:
            self._check_open_locked()
            if dataset_id in self._datasets:
                raise DatasetExistsError(
                    f"dataset {dataset_id!r} already registered; resident "
                    "shards are immutable — drop() it first"
                )

    def _check_open_locked(self) -> None:
        if self._closed:
            raise ServerClosedError(
                "registry is closed; datasets can no longer be registered"
            )

    def _register(self, ds: ResidentDataset) -> ResidentDataset:
        with self._lock:
            # closed-ness is decided under the insert's lock: a
            # registration racing close() lands before its snapshot or
            # fails, and never books bytes the close will not release
            self._check_open_locked()
            if ds.dataset_id in self._datasets:
                raise DatasetExistsError(
                    f"dataset {ds.dataset_id!r} already registered; resident "
                    "shards are immutable — drop() it first"
                )
            self._datasets[ds.dataset_id] = ds
        _ldg.LEDGER.adjust_bytes("resident", ds.residency, ds.nbytes)
        return ds

    def add_array(
        self,
        dataset_id: str,
        data,
        *,
        sketch: bool = True,
        sketch_bits: int = DEFAULT_SKETCH_BITS,
        sketch_levels: int = DEFAULT_SKETCH_LEVELS,
        device=None,
    ) -> ResidentDataset:
        """Register an in-core dataset: ``data`` goes once through
        :func:`~mpi_k_selection_tpu_torch.api.as_selection_array` to
        ``device`` (a tensor stays where it is when ``device`` is None;
        anything else goes to ``"cuda"``) and is cloned unless that copied
        it. The resident sketch counts the resident tensor on its own
        device, in views of :data:`SKETCH_VIEW` keys (the sweep kernel's
        sketch part on a card, its plain version on the CPU), so sketch
        and exact answers describe the same bits."""
        from mpi_k_selection_tpu_torch.api import as_selection_array
        from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch, sketch_dtype

        self._check_new_id(dataset_id)
        x = as_selection_array(data, device).reshape(-1)
        if x.numel() == 0:
            raise QueryError("cannot register an empty dataset")
        if x.device.type == "cpu" or (isinstance(data, torch.Tensor) and x.device == data.device):
            x = x.clone()
        dev = _recorded_device(x, device)
        dtype = sketch_dtype(x.dtype)
        sk = None
        if sketch:
            sk = RadixSketch(dtype, radix_bits=sketch_bits, levels=sketch_levels, device=dev)
            for off in range(0, x.numel(), SKETCH_VIEW):
                sk.update(x[off:off + SKETCH_VIEW])
        return self._register(
            ResidentDataset(
                dataset_id=dataset_id,
                residency="device",
                dtype=dtype,
                n=int(x.numel()),
                data=x,
                sketch=sk,
                device=dev,
            )
        )

    def add_stream(
        self,
        dataset_id: str,
        source,
        *,
        sketch: bool = True,
        sketch_bits: int = DEFAULT_SKETCH_BITS,
        sketch_levels: int = DEFAULT_SKETCH_LEVELS,
        device=None,
        **stream_kwargs,
    ) -> ResidentDataset:
        """Register an out-of-core dataset from a replayable chunk source
        (a list or tuple of chunks, a zero-arg callable returning a fresh
        iterator, or a SpillStore with a committed generation). One pass
        runs here to build the sketch (and learn n and the dtype), counted
        on ``device`` (default ``"cuda"``); exact queries replay the
        source through the sketch-seeded streamed descent there.
        ``stream_kwargs`` are kept for those descents (``pipeline_depth``,
        ``devices``, ``width_schedule``, ``pack_spill``,
        ``ingest_workers``, ...); the sketch pass takes the staging subset
        (``pipeline_depth``, default 0 here, ``devices``,
        ``ingest_workers``). The JAX package's ``fused``, ``deferred`` and
        ``hist_method`` are refused here."""
        from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
        from mpi_k_selection_tpu_torch.streaming.chunked import as_chunk_source
        from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch, reject_later_knobs, sketch_dtype

        reject_later_knobs(
            "DatasetRegistry.add_stream", {k: v for k, v in stream_kwargs.items() if k in REFUSED_STREAM_KNOBS}
        )
        self._check_new_id(dataset_id)
        dev = str(_pl.resolve_device(device))
        src = as_chunk_source(source)  # refuses one-shot sources
        dtype = None
        for chunk in src():  # the dtype probe; the fold is one pass below
            cdt = getattr(chunk, "orig_dtype", None)  # spill records
            if cdt is not None:
                dtype = sketch_dtype(cdt)
                break
            if isinstance(chunk, torch.Tensor):
                if chunk.numel():
                    dtype = sketch_dtype(chunk.dtype)
                    break
                continue
            c = np.ravel(np.asarray(chunk))
            if c.size:
                dtype = np.dtype(c.dtype)
                break
        if dtype is None:
            raise QueryError("cannot register an empty dataset")
        sk = RadixSketch(dtype, radix_bits=sketch_bits, levels=sketch_levels, device=dev)
        sk.update_stream(
            src,
            pipeline_depth=stream_kwargs.get("pipeline_depth", 0),
            devices=stream_kwargs.get("devices"),
            ingest_workers=stream_kwargs.get("ingest_workers"),
        )
        n = int(sk.n)
        if n == 0:
            raise QueryError("cannot register an empty dataset")
        return self._register(
            ResidentDataset(
                dataset_id=dataset_id,
                residency="stream",
                dtype=dtype,
                n=n,
                source=src,
                # the pass is the sketch build; keep it visible only when asked
                sketch=sk if sketch else None,
                stream_kwargs=dict(stream_kwargs),
                device=dev,
            )
        )

    def get(self, dataset_id: str) -> ResidentDataset:
        with self._lock:
            ds = self._datasets.get(dataset_id)
        if ds is None:
            raise DatasetNotFoundError(f"no dataset registered as {dataset_id!r}")
        return ds

    def drop(self, dataset_id: str) -> None:
        with self._lock:
            ds = self._datasets.get(dataset_id)
            if ds is None:
                raise DatasetNotFoundError(
                    f"no dataset registered as {dataset_id!r}"
                )
            del self._datasets[dataset_id]
        _ldg.LEDGER.adjust_bytes("resident", ds.residency, -ds.nbytes)
        self.programs.drop_dataset(dataset_id)

    def close(self) -> None:
        """Unregister every dataset, returning its bytes to the resident
        book and its cached programs to the allocator. Idempotent; a race
        with :meth:`drop` subtracts each dataset once. A closed registry
        refuses new registrations."""
        with self._lock:
            self._closed = True
            datasets = list(self._datasets.values())
            self._datasets.clear()
        for ds in datasets:
            _ldg.LEDGER.adjust_bytes("resident", ds.residency, -ds.nbytes)
            self.programs.drop_dataset(ds.dataset_id)

    def list_datasets(self) -> list[dict]:
        with self._lock:
            datasets = list(self._datasets.values())
        return [ds.summary() for ds in sorted(datasets, key=lambda d: d.dataset_id)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._datasets)

    # -- selection dispatch (lane threads only) ----------------------------

    def select_many(self, ds: ResidentDataset, ks) -> np.ndarray:
        """Exact values at the 1-indexed ranks ``ks``, in order, as a NumPy
        array of the dataset's dtype: the exact tier's entry. The dispatch
        is :func:`~mpi_k_selection_tpu_torch.api.kselect_many`'s (the sort
        leg, in ``lax.sort``'s order, for n <= 2^14 or many ranks; else the
        shared radix walk), with the built pieces from :attr:`programs`,
        so answers equal one ``api.kselect`` a rank bit for bit."""
        from mpi_k_selection_tpu_torch.api import many_takes_sort

        ks = [int(k) for k in ks]
        for k in ks:
            if not 1 <= k <= ds.n:
                raise QueryError(f"k={k} out of range [1, {ds.n}]")
        if ds.residency == "stream":
            fn = self.programs.get_or_build(
                ("stream_select", ds.dataset_id),
                lambda: self._build_stream_select(ds),
            )
            return np.asarray(fn(ks))
        if many_takes_sort(ds.n, len(ks)):
            s = self.programs.get_or_build(
                ("sorted", ds.dataset_id), lambda: self._build_sorted(ds)
            )
            idx = torch.as_tensor(np.clip(np.asarray(ks, np.int64) - 1, 0, ds.n - 1), device=s.device)
            # through the signed view: CUDA has no index kernel for uint16/32/64
            return tensor_to_numpy(bit_view(s)[idx].view(s.dtype))
        # keyed per dataset, not per batch width: the closure serves any
        # width, and width-keyed entries could evict the costly cached sort
        fn = self.programs.get_or_build(
            ("walk", ds.dataset_id),
            lambda: self._build_walk(ds),
        )
        return fn(ks)

    # -- registration-time warmup ------------------------------------------

    def warmup(self, ds: ResidentDataset) -> int:
        """Build every program :meth:`select_many` can reach for this
        dataset through :class:`ProgramCache`, so their build wall lands in
        the ledger's compile span at registration instead of on the first
        client; returns the programs built (0 when all were resident).

        The warm builders run each program once: the cached sort is
        synchronized, and the walk answers one width-1 query, which builds
        the walk's kernel source with ``nvcc`` when the process has not yet
        (ops/cuda/build.py) and launches each of its kernels. A warmed
        dataset's steady query mix then books zero builds at the
        ``serve.programs`` site."""
        miss0 = self.programs.misses
        if ds.residency == "stream":
            # the descent's closure is host logic; building it here takes
            # the first query's cache miss off the request path
            self.programs.get_or_build(
                ("stream_select", ds.dataset_id),
                lambda: self._build_stream_select(ds),
            )
        else:
            self.programs.get_or_build(
                ("sorted", ds.dataset_id),
                lambda: self._build_sorted_warm(ds),
            )
            if ds.n > 1 << 14:  # large datasets send narrow batches to the walk
                self.programs.get_or_build(
                    ("walk", ds.dataset_id),
                    lambda: self._build_walk_warm(ds),
                )
        built = self.programs.misses - miss0
        if ds.sketch is not None:
            # the sketch reads are NumPy, but their first touch builds the
            # pyramid's cumulative views: warm them too
            ds.sketch.pin(1)
            ds.sketch.rank_bounds(1)
            ds.sketch.value_bounds(1)
        return built

    @staticmethod
    def _build_sorted_warm(ds: ResidentDataset):
        """:meth:`_build_sorted`, synchronized, so the sort's wall lands
        inside the warmup's compile span."""
        s = DatasetRegistry._build_sorted(ds)
        if s.is_cuda:
            torch.cuda.synchronize(s.device)
        return s

    @staticmethod
    def _build_walk_warm(ds: ResidentDataset):
        """:meth:`_build_walk` plus one width-1 query: the kernel build and
        first launches happen inside the warmup's compile span."""
        fn = DatasetRegistry._build_walk(ds)
        fn([1])
        return fn

    @staticmethod
    def _build_sorted(ds: ResidentDataset) -> torch.Tensor:
        """The sort leg's state: the dataset sorted once, in ``lax.sort``'s
        order (ops/sort.py:``sort_order_keys``, a stable sort: ``-0.0``
        and ``+0.0`` tie, NaNs last, ties in position order), each element
        with its own bits. Every later sort-leg batch is a gather."""
        from mpi_k_selection_tpu_torch.ops.sort import sort_order_keys

        order = torch.sort(sort_order_keys(ds.data), stable=True).indices
        return bit_view(ds.data)[order].view(ds.data.dtype)

    @staticmethod
    def _build_walk(ds: ResidentDataset):
        """The shared multi-rank walk over the resident tensor
        (ops/radix.py:``radix_select_many``, the histogram kernels on a
        card), answers as a NumPy array."""
        from mpi_k_selection_tpu_torch.ops.radix import radix_select_many

        def fn(ks):
            kk = torch.as_tensor(np.asarray(ks, np.int64), device=ds.data.device)
            return tensor_to_numpy(radix_select_many(ds.data, kk))

        return fn

    @staticmethod
    def _build_stream_select(ds: ResidentDataset):
        """Exact streamed multi-rank select: the resident sketch's
        ``refine_many`` (its resolved prefix skips ``levels`` streamed
        passes) when one is kept, else the bare shared-pass descent, on
        the dataset's device."""
        kwargs = dict(ds.stream_kwargs)
        if ds.sketch is not None:
            return lambda ks: ds.sketch.refine_many(ds.source, ks, **kwargs)
        from mpi_k_selection_tpu_torch.streaming.chunked import streaming_kselect_many

        return lambda ks: streaming_kselect_many(ds.source, ks, device=ds.device, **kwargs)

    # -- non-rank ops (lane threads only) ----------------------------------

    def topk(self, ds: ResidentDataset, k: int, *, largest: bool = True):
        """Top-k ``(values, int64 indices)`` of a resident dataset as NumPy
        arrays (ops/topk.py: ties by ascending position). A stream dataset
        raises: re-streaming the source per query would break the latency
        contract."""
        if not 1 <= int(k) <= ds.n:
            raise QueryError(f"topk k={k} out of range [1, {ds.n}]")
        k = int(k)
        if ds.residency == "stream":
            raise QueryError(
                "topk requires a resident (array) dataset; "
                f"{ds.dataset_id!r} is stream-resident"
            )
        from mpi_k_selection_tpu_torch.ops.topk import topk as _topk

        v, i = _topk(ds.data, k, largest=largest)
        return tensor_to_numpy(v), tensor_to_numpy(i)

    def rank_certificate(self, ds: ResidentDataset, value):
        """Exact ``(#<, #<=)`` counts of ``value`` (in the dataset's dtype)
        in key order: the O(n) proof that an answer is the true order
        statistic."""
        if ds.residency == "stream":
            from mpi_k_selection_tpu_torch.streaming.chunked import (
                streaming_rank_certificate,
            )

            kwargs = {
                key: ds.stream_kwargs[key]
                for key in ("pipeline_depth", "devices")
                if key in ds.stream_kwargs
            }
            less, leq = streaming_rank_certificate(ds.source, value, device=ds.device, **kwargs)
            return int(less), int(leq)
        from mpi_k_selection_tpu_torch.utils import debug

        v = tensor_from_numpy(np.asarray([value], ds.dtype), ds.data.device)
        less, leq = debug.rank_certificate(ds.data, v)
        return int(less), int(leq)
