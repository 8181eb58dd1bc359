"""Radix-digit histograms — the hot primitive of k-selection (PyTorch).

Counterpart of ``mpi_k_selection_tpu/ops/histogram.py``. Per pass,
``hist[b] = #{ i : active(i) and digit(i) == b }`` where ``digit(i) =
(key >> shift) & (R-1)`` and ``active(i)`` means the key's bits above the
digit equal the current prefix.

The method follows the tensor's device (:func:`resolve_hist_method`): the
hand-written kernel (ops/cuda/histogram.py) for a CUDA tensor, its plain
PyTorch version for a CPU tensor. No path moves from the card to the CPU
or from a kernel to its plain version.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.ops.cuda.histogram import (
    radix_histogram,
    radix_histogram_multi,
    resolve_hist_method,
)
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

# the reference's name for the per-pass histogram: ``(2**radix_bits,)``
# int64 counts of the digit at ``shift`` over the active keys of ``words``
# (see ops/cuda/histogram.py:radix_histogram for the word and prefix contract)
masked_radix_histogram = radix_histogram

# the shared-sweep primitive of multi-rank selection: ``(K, 2**radix_bits)``
# int64 histograms, one per prefix, from ONE read of the words for every
# device (the JAX package's K-reads fallback for non-Pallas methods has no
# counterpart: the plain version is the CPU route)
multi_masked_radix_histogram = radix_histogram_multi

__all__ = ["masked_radix_histogram", "multi_masked_radix_histogram", "prepare_raw", "resolve_hist_method"]


def prepare_raw(x):
    """``(words, key_op, key_xor)`` for the raw-bits kernel input, or None
    when ``x``'s dtype has no in-kernel key transform (sub-32-bit dtypes,
    utils/dtypes.py:key_fold).

    ``words`` is ``x`` flattened and viewed as int32/int64 — no copy for a
    contiguous ``x``: the kernels apply the sortable-key transform as they
    read, so the select never writes a key array."""
    fold = _dt.key_fold(x.dtype)
    if fold is None:
        return None
    words = x.reshape(-1).view(_dt.key_dtype(x.dtype))
    return words, fold[0], fold[1] if fold[0] == "xor" else 0
