"""Selection operators: histograms, radix descent, sort, top-k (the JAX
``mpi_k_selection_tpu.ops`` names)."""

from mpi_k_selection_tpu_torch.ops.histogram import masked_radix_histogram
from mpi_k_selection_tpu_torch.ops.radix import radix_select
from mpi_k_selection_tpu_torch.ops.sort import sort_select
from mpi_k_selection_tpu_torch.ops.topk import batched_topk, topk

__all__ = [
    "sort_select",
    "radix_select",
    "topk",
    "batched_topk",
    "masked_radix_histogram",
]
