"""Exact k-selection in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch / CUDA port of ``mpi_k_selection_tpu`` (which stays the JAX
reference). Ported so far: exact single-array selection, the reference's
main path::

    import mpi_k_selection_tpu_torch as kt
    kt.kselect(x, k)     # exact k-th smallest (1-indexed), 0-d tensor
    kt.median(x)         # lower median, k = max(1, n // 2)

``x`` is a torch tensor (selection runs on its device) or anything NumPy
takes (moved to ``device``, default ``"cuda"``). The radix passes run the
kernels of ``csrc/histogram.cu``, built with ``nvcc`` at first use; a CPU
tensor runs their plain PyTorch versions.
"""

from mpi_k_selection_tpu_torch.api import as_selection_array, kselect, median
from mpi_k_selection_tpu_torch.ops.radix import radix_select
from mpi_k_selection_tpu_torch.ops.sort import sort_select

__all__ = ["as_selection_array", "kselect", "median", "radix_select", "sort_select"]
