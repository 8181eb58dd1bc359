"""The port's resource-protocol registry: the one importable source of
every leak-tracked resource family's names.

Counterpart of ``mpi_k_selection_tpu/resource_protocols.py``. Three
layers key on the names below:

1. **runtime** — the test suite's leak checks match worker threads,
   spill directories and flight-recorder files by these prefixes;
2. **static** — the lifecycle pass (analysis/lifecycle.py, KSL019-KSL021)
   and the placement pass (analysis/placement.py, KSL022-KSL024) read the
   acquire, release, owner, crossing and dispatch vocabularies here;
3. **the owning modules** — streaming/pipeline.py, serve/batcher.py,
   monitor/monitor.py, streaming/spill.py and obs/flight.py re-export
   their prefix constants from here under their own names.

It imports nothing but the standard library.
"""

from __future__ import annotations

#: Every package-owned leakable artifact carries this prefix.
KSEL_PREFIX = "ksel-"

# -- worker-thread name prefixes (the KSL021 thread family) ------------------

#: streaming/pipeline.py ChunkPipeline producer threads.
PIPELINE_THREAD_PREFIX = "ksel-pipeline"
#: The JAX package's parallel ingest and decode pools; the port's
#: ``ingest_workers`` runs one producer (ROADMAP Queue 1 item 3a), so no
#: port thread carries it yet.
INGEST_THREAD_PREFIX = "ksel-ingest"
#: serve/ threads: the dispatch lanes' batcher threads, the HTTP serve
#: loop and its request handlers.
SERVE_THREAD_PREFIX = "ksel-serve"
#: monitor/ metrics-server threads (serve loop and request handlers).
MONITOR_THREAD_PREFIX = "ksel-monitor"

THREAD_PREFIXES = (
    PIPELINE_THREAD_PREFIX,
    INGEST_THREAD_PREFIX,
    SERVE_THREAD_PREFIX,
    MONITOR_THREAD_PREFIX,
)

# -- on-disk artifact prefixes ------------------------------------------------

#: streaming/spill.py store directories made by the store itself.
SPILL_DIR_PREFIX = "ksel-spill-"
#: obs/flight.py debug-bundle files.
FLIGHT_FILE_PREFIX = "ksel-flight-"

#: The whole leak-tracked prefix family (threads and disk artifacts).
RESOURCE_PREFIXES = THREAD_PREFIXES + (SPILL_DIR_PREFIX, FLIGHT_FILE_PREFIX)

# ---------------------------------------------------------------------------
# static lifecycle protocols (analysis/lifecycle.py)
#
# For each resource family: the calls that ACQUIRE a tracked resource, the
# calls that RELEASE it, the calls and attributes that TRANSFER ownership
# to an owner with its own checked discipline, and the class names used
# for isinstance() narrowing.

# -- staged key buffers (KSL019): streaming/pipeline.py -----------------------

#: Calls whose result is a live StagedKeys (a staged bucket on its slot).
STAGED_ACQUIRE_CALLS = frozenset({"stage_chunk"})
#: ``staged.release()`` — gives the pinned and device buffers back.
STAGED_RELEASE_METHODS = frozenset({"release"})
#: ``release_staged(x)`` — the idempotent unwind helper (executor.py).
STAGED_RELEASE_FUNCS = frozenset({"release_staged"})
#: Calls that take ownership of a staged buffer passed to them: the
#: executor's window (``push``) releases at bundle finish; the pipeline
#: queue (``put``/``_put``) hands it to the consumer, and close() drains
#: and releases what was never consumed.
STAGED_OWNER_CALLS = frozenset({"push", "put", "_put"})
STAGED_TYPES = frozenset({"StagedKeys"})

# -- spill stores / writers / temp dirs (KSL020): streaming/spill.py ----------

#: Constructors of caller-cleaned disk resources: a store (close() removes
#: its ksel-spill-* dir), a generation writer (commit() or abort()), a raw
#: temp dir.
SPILL_ACQUIRE_CALLS = frozenset(
    {"SpillStore", "SpillWriter", "TemporaryDirectory", "mkdtemp", "new_generation"}
)
#: The cleanup surface: ``store.close()``, ``writer.abort()`` /
#: ``writer.commit()`` (commit hands the records to the store),
#: ``TemporaryDirectory.cleanup()``.
SPILL_RELEASE_METHODS = frozenset({"close", "abort", "commit", "cleanup"})
SPILL_RELEASE_FUNCS = frozenset()
SPILL_OWNER_CALLS = frozenset()
#: ``self.root = tempfile.mkdtemp(...)`` — the store owns its directory.
SPILL_OWNER_ATTRS = frozenset({"root"})
SPILL_TYPES = frozenset({"SpillStore", "SpillWriter", "TemporaryDirectory"})

# -- package worker threads (KSL021) ------------------------------------------

#: Only ``ksel-``-named threads are tracked; an unstarted Thread holds no
#: OS resources, so the obligation arms at ``.start()``.
THREAD_ACQUIRE_CALLS = frozenset({"Thread"})
THREAD_RELEASE_METHODS = frozenset({"join"})
THREAD_RELEASE_FUNCS = frozenset()
THREAD_OWNER_CALLS = frozenset()
#: Supervisor slots whose owners join their threads on every close path:
#: ChunkPipeline._thread, QueryBatcher._thread, the HTTP servers'
#: _serve_thread and _req_threads (serve/http.py, monitor/monitor.py) and
#: the LaneDispatcher's _lanes (serve/lanes.py: each lane is a batcher
#: whose close() joins its own thread); ``_workers`` is kept for the pooled
#: ingest plane.
THREAD_OWNER_ATTRS = frozenset({"_thread", "_serve_thread", "_req_threads", "_lanes", "_workers"})
THREAD_TYPES = frozenset({"Thread"})

# ---------------------------------------------------------------------------
# ``# ksel-torch: owner[<site>]`` annotation vocabulary
#
# A declared ownership transfer names one of these sites; any other name,
# or an annotation on a line where no tracked resource moves, is a finding.
# The lifecycle report exports this table verbatim.

OWNER_SITES = {
    "InflightWindow": "the executor FIFO window releases at bundle finish",
    "StreamExecutor": "the stream executor owns staged-buffer lifetime",
    "ChunkPipeline": "the pipeline queue: close() drains and releases",
    "SpillStore": "the store owns committed generations (drop/close)",
    "supervisor": "a conftest-recognized thread supervisor joins it",
    "caller": "ownership returns to the caller (documented contract)",
}

# ---------------------------------------------------------------------------
# device-placement vocabulary (analysis/placement.py, KSL022-KSL024, KSC105)
#
# The placement pass models where each value lives: ``host``,
# ``device(slot)``, ``slots`` (a resolved device tuple), ``round-robin``
# (slots indexed by chunk position), ``inherited`` (a device chunk's own
# device) or ``top`` (conflicting placements met).

# -- placement sources ----------------------------------------------------------

#: Tensor methods that move a tensor between the host and a card, or
#: between cards. ``.to(...)`` counts only with a device target (a
#: ``device=`` keyword, or a first argument that names a device rather than
#: a dtype); ``copy_`` only with ``non_blocking``.
TRANSFER_PUT_METHODS = frozenset({"to", "cuda"})
#: Keyword arguments that name the target of a transfer.
PUT_TARGET_KWARGS = frozenset({"device"})
#: Staging constructors whose result carries its device argument's slot.
STAGE_CALLS = frozenset({"stage_chunk"})
INHERIT_STAGE_CALLS = frozenset()
#: The slot-tuple resolver: round-robin staging indexes its result by
#: chunk position.
SLOT_RESOLVER_CALLS = frozenset({"resolve_stream_devices"})

# -- dispatch / threading sites -------------------------------------------------

#: The kernel wrappers a bucket is read by (the KSL014 family): every
#: operand of one dispatch must agree on one slot (KSL022). ``_Descent``
#: (ops/radix.py) calls the histogram wrappers directly: the port has no
#: ``masked_radix_histogram`` layer of its own beyond their aliases.
DISPATCH_CALLS = frozenset(
    {
        "radix_histogram",
        "radix_histogram_multi",
        "match_counts",
        "tau_counts",
        "sweep_ingest",
        "batched_topk",
    }
)
#: Calls that take the resolved device tuple via ``devices=`` and thread it
#: into round-robin staging (the KSL022 drop-site family).
DEVICE_THREADING_CALLS = frozenset(
    {"_key_chunk_stream", "ChunkPipeline", "streaming_kselect", "streaming_kselect_many", "update_stream"}
)

# -- sanctioned host<->device crossings (KSL023) -------------------------------

#: Tensor methods that cross between the host and a card in every use:
#: reads to the host (each waits for the card) and the explicit upload.
CROSSING_METHODS = frozenset({"cuda", "cpu", "numpy", "item", "tolist"})
#: Every crossing spelling the placement pass censuses: the methods above,
#: ``.to(<device>)`` and a ``non_blocking`` ``copy_``.
CROSSING_CALLS = CROSSING_METHODS | frozenset({"to", "copy_"})
#: The sanctioned transfer sites: package-relative module path -> why that
#: module may cross. A crossing in streaming/, serve/, monitor/, ops/ or
#: parallel/ outside this table is a KSL023 finding. The placement report
#: exports it verbatim.
SANCTIONED_TRANSFER_SITES = {
    "streaming/pipeline.py": (
        "the staging boundary: stage_chunk copies each bucket from a pinned "
        "buffer to its round-robin slot, non_blocking on the slot's copy stream"
    ),
    "streaming/executor.py": (
        "the readbacks: the consumers read each bucket's counts, survivors and "
        "certificate to the host when the in-flight window pops"
    ),
    "streaming/chunked.py": (
        "the pass-0 spill tee: a device chunk's keys encoded on the host "
        "(the JAX package's host tee), once a chunk"
    ),
    "ops/sort.py": "the small-n sort path's one scalar read",
    "ops/cuda/sweep_ingest.py": (
        "prefixes and specs past what a launch takes by value, uploaded from "
        "pinned memory without a host wait; the wide route's prefix table, read "
        "once a pass"
    ),
    "parallel/mesh.py": "the gloo collectives: tensors cross to the host for a CPU process group",
    "parallel/topk.py": "the shards' candidates gathered to the host over gloo",
    "parallel/sketch.py": "the sketches' counts reduced over gloo and merged on the host",
}

# -- placement-nondeterminism sources (KSL024) ----------------------------------

#: Calls whose result may never feed a device-target expression: device
#: choice is a pure function of chunk index, an explicit knob or a
#: recorded slot, or spill replay cannot re-stage deterministically.
NONDET_PLACEMENT_CALLS = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "threading.get_ident",
        "threading.current_thread",
        "get_ident",
        "current_thread",
        "random.random",
        "random.randint",
        "random.randrange",
        "random.choice",
        "random.getrandbits",
        "os.urandom",
        "uuid.uuid1",
        "uuid.uuid4",
        "hash",
        "id",
    }
)
#: Constructors whose iteration order is no contract.
UNORDERED_CONSTRUCTORS = frozenset({"set", "frozenset"})
