"""Exact selection over chunked streams that never lie whole on one device
(counterpart of ``mpi_k_selection_tpu/streaming``).

- ``chunked.py``: the chunk sources, the radix descent shared across
  ranks (``streaming_kselect``, ``streaming_kselect_many``) and the
  streamed rank certificate (``streaming_rank_certificate``).
- ``pipeline.py``: staging host chunks onto the card through pinned
  buffers (a pool of them, reused), and the producer thread that
  overlaps it with the descent; at ``ingest_workers`` > 1 the pooled host
  data plane (a puller, ``ksel-ingest-*`` workers, a reorder sequencer).
- ``executor.py``: the per-chunk consumers, each one launch of the sweep
  kernel (``ops/cuda/sweep_ingest.py``) per staged chunk, and the FIFO
  scheduler that folds their results on the host in chunk order.
- ``sketch.py``: ``RadixSketch``, the mergeable online-quantile sketch
  whose counts come from the sweep kernel's sketch part, and which seeds
  the descent (``sketch=``, ``refine``).
- ``spill.py``: ``SpillStore``, the survivor spill store (formats v1 and
  v2, the JAX package's records byte for byte): pass 0 tees the stream to
  disk, later passes read the shrinking generations (``spill=``;
  ``pack_spill="auto"`` packs them and prunes the reads; ``workers`` > 1
  decodes them on a pool).

The names are the JAX subpackage's, less those of its XLA and Pallas
tiers (``fused``, ``deferred``, ``kernel_tier_available``) and of its
padded staging of chunks already on a device (``stage_device_keys``): the
port runs one sweep kernel a chunk and stages each chunk at its own
length.
"""

from mpi_k_selection_tpu_torch.streaming.chunked import (
    DEFAULT_SPILL,
    as_chunk_source,
    streaming_kselect,
    streaming_kselect_many,
    streaming_rank_certificate,
)
from mpi_k_selection_tpu_torch.streaming.executor import FusedIngestConsumer, StreamExecutor, collect_hidden_frac
from mpi_k_selection_tpu_torch.streaming.pipeline import (
    DEFAULT_PIPELINE_DEPTH,
    ChunkPipeline,
    StagedKeys,
    StagingPool,
    encode_hidden_frac,
    ingest_hidden_frac,
    live_staged_keys,
    resolve_stream_devices,
)
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.streaming.spill import SPILL_DIR_PREFIX, SPILL_MODES, SpillGeneration, SpillStore

__all__ = [
    "ChunkPipeline",
    "DEFAULT_PIPELINE_DEPTH",
    "DEFAULT_SPILL",
    "FusedIngestConsumer",
    "RadixSketch",
    "SPILL_DIR_PREFIX",
    "SPILL_MODES",
    "SpillGeneration",
    "SpillStore",
    "StagedKeys",
    "StagingPool",
    "StreamExecutor",
    "as_chunk_source",
    "collect_hidden_frac",
    "encode_hidden_frac",
    "ingest_hidden_frac",
    "live_staged_keys",
    "resolve_stream_devices",
    "streaming_kselect",
    "streaming_kselect_many",
    "streaming_rank_certificate",
]
