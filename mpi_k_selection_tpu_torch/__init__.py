"""Exact k-selection in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch / CUDA port of ``mpi_k_selection_tpu`` (which stays the JAX
reference). Ported so far: exact selection of one rank, of many ranks,
per-row selection of a batch, 1-D top-k, batched top-k, and exact
selection over a stream of chunks::

    import mpi_k_selection_tpu_torch as kt
    kt.kselect(x, k)             # exact k-th smallest (1-indexed), 0-d tensor
    kt.median(x)                 # lower median, k = max(1, n // 2)
    kt.kselect_many(x, ks)       # every k in ks, one shared walk
    kt.quantiles(x, [0.5, 0.99]) # nearest-rank quantiles
    kt.topk(x, k)                # (values, int64 indices), ties by position
    kt.batched_topk(x2d, k)      # per row of (B, D); the block kernel for k <= 16
    kt.batched_kselect(x2d, k)   # per-row k-th smallest (k scalar or per row)
    kt.batched_median(x2d)       # per-row lower median
    kt.kselect_streaming(chunks, k)       # over a replayable chunk source
    kt.kselect_streaming_many(chunks, ks) # every k, the passes shared
    kt.streaming_rank_certificate(chunks, v)  # (#< v, #<= v), streamed
    kt.kselect_streaming(iter(chunks), k)  # a one-shot stream: the spill store
    with kt.SpillStore() as store:         # a store the caller owns
        kt.kselect_streaming(chunks, k, spill=store)  # store.pass_log, generation 0 kept
    kt.StreamingQuantiles(dtype).update_stream(chunks)  # mergeable online quantiles
    kt.RadixSketch(dtype)        # the sketch under it: exact bounds, refine()
    kt.WindowedSketch(dtype, window=8)  # a sliding window of sketches
    kt.Monitor(window=8).run(chunk_iter, dtype)  # p50/p90/p99 samples, one pass
    kt.kselect_streaming(chunks, k, devices=2)   # chunk j staged on card j % 2
    kt.Observability.collecting()  # telemetry (obs= on the entry points): events, metrics, spans
    with kt.KSelectServer(window=0.002) as srv:  # the resident-dataset query server (serve/)
        srv.add_dataset("x", x, warmup=True)      # placed on cuda and built once
        srv.kselect("x", k, tier="auto")          # a RankAnswer; tier "sketch" carries exact bounds

Distributed selection runs one process per rank over a
``torch.distributed`` group (parallel/): every rank calls the entry point
with the same global input and gets the answer::

    kt.run_ranks(fn, 4, device="cuda")  # fn(mesh) on 4 spawned ranks
    kt.distributed_radix_select(x, k, mesh=mesh)        # a histogram all_reduce a pass
    kt.distributed_radix_select_many(x, ks, mesh=mesh)
    kt.distributed_cgm_select(x, k, mesh=mesh, return_rounds=True)  # the reference's CGM
    kt.distributed_topk(x, k, mesh=mesh)
    kt.distributed_sketch(x, mesh=mesh)  # a RadixSketch, two all_reduces

``kt.get_backend("seq" | "cuda" | "mpi")`` gives the backends (the NumPy
oracle, this package, the native forked-rank CGM), and
``kt.DeviceVector`` the reference's ``IntVector`` ADT on a device.

``x`` is a torch tensor (selection runs on its device) or anything NumPy
takes (moved to ``device``, default ``"cuda"``). The radix passes and the
top-k collect run the kernels of ``csrc/histogram.cu``, the batched top-k
the kernel of ``csrc/topk.cu``, the streamed passes the kernel of
``csrc/sweep_ingest.cu`` (its sketch part for the sketches and the
monitor), built with ``nvcc`` at first use; a CPU tensor
(or ``device="cpu"``) runs their plain PyTorch versions.
"""

from mpi_k_selection_tpu_torch.api import (
    StreamingQuantiles,
    as_selection_array,
    batched_kselect,
    batched_median,
    kselect,
    kselect_many,
    kselect_streaming,
    kselect_streaming_many,
    median,
    quantiles,
    streaming_rank_certificate,
)
from mpi_k_selection_tpu_torch.backends import get_backend
from mpi_k_selection_tpu_torch.buffer import DeviceVector
from mpi_k_selection_tpu_torch.monitor import Monitor, WindowedSketch
from mpi_k_selection_tpu_torch.obs import Observability
from mpi_k_selection_tpu_torch.ops.radix import radix_select, radix_select_many
from mpi_k_selection_tpu_torch.ops.sort import sort_select
from mpi_k_selection_tpu_torch.ops.topk import batched_topk, topk
from mpi_k_selection_tpu_torch.serve import KSelectServer
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
from mpi_k_selection_tpu_torch.parallel import (
    DISTRIBUTED_ALGORITHMS,
    distributed_cgm_select,
    distributed_kselect,
    distributed_radix_select,
    distributed_radix_select_many,
    distributed_sketch,
    distributed_topk,
    make_mesh,
    run_ranks,
)

__all__ = [
    "DISTRIBUTED_ALGORITHMS", "DeviceVector", "KSelectServer", "Monitor", "Observability", "RadixSketch", "SpillStore",
    "StreamingQuantiles", "WindowedSketch",
    "as_selection_array", "batched_kselect", "batched_median", "batched_topk", "distributed_cgm_select",
    "distributed_kselect", "distributed_radix_select", "distributed_radix_select_many", "distributed_sketch",
    "distributed_topk", "get_backend", "kselect", "kselect_many", "kselect_streaming", "kselect_streaming_many",
    "make_mesh", "median", "quantiles", "radix_select", "radix_select_many", "run_ranks", "sort_select",
    "streaming_rank_certificate", "topk",
]
