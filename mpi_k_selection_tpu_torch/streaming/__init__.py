"""Exact selection over chunked streams that never lie whole on one device
(counterpart of ``mpi_k_selection_tpu/streaming``).

- ``chunked.py``: the chunk sources, the radix descent shared across
  ranks (``streaming_kselect``, ``streaming_kselect_many``) and the
  streamed rank certificate (``streaming_rank_certificate``).
- ``pipeline.py``: staging host chunks onto the card through pinned
  buffers (a pool of them, reused), and the producer thread that
  overlaps it with the descent.
- ``executor.py``: the per-chunk consumers, each one launch of the sweep
  kernel (``ops/cuda/sweep_ingest.py``) per staged chunk, and the FIFO
  scheduler that folds their results on the host in chunk order.
- ``sketch.py``: ``RadixSketch``, the mergeable online-quantile sketch
  whose counts come from the sweep kernel's sketch part, and which seeds
  the descent (``sketch=``, ``refine``).
- ``spill.py``: ``SpillStore``, the survivor spill store (formats v1 and
  v2, the JAX package's records byte for byte): pass 0 tees the stream to
  disk, later passes read the shrinking generations (``spill=``;
  ``pack_spill="auto"`` packs them and prunes the reads).
"""
