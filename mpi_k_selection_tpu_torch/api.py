"""High-level selection API (counterpart of ``mpi_k_selection_tpu/api.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` or a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.ops.radix import radix_select
from mpi_k_selection_tpu_torch.ops.sort import sort_select
from mpi_k_selection_tpu_torch.utils.debug import check_concrete_k
from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

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


def kselect(x, k, *, algorithm: str = "auto", device=None, **kwargs) -> torch.Tensor:
    """Exact k-th smallest element (1-indexed k, reference semantics:
    ``kth-problem-seq.c:32-33``), a 0-d tensor on the input's device.
    ``kwargs`` go to :func:`~mpi_k_selection_tpu_torch.ops.radix.radix_select`."""
    x = as_selection_array(x, device)
    if x.numel() == 0:
        raise ValueError("kselect requires a non-empty input")
    check_concrete_k(k, x.numel())
    if resolve_algorithm(algorithm, x.numel()) == "radix":
        return radix_select(x, k, **kwargs)
    return sort_select(x, k)


def median(x, *, device=None, **kwargs) -> torch.Tensor:
    """Lower median: k = max(1, n//2), the reference's median operating
    point."""
    x = as_selection_array(x, device)
    return kselect(x, max(1, x.numel() // 2), **kwargs)
