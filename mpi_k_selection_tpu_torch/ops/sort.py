"""Sort-then-index selection — the small-input path and an on-device oracle.

The reference's sequential semantics (``kth-problem-seq.c:32-33``): sort
ascending and take element ``k-1``. The sort runs over the order-preserving
keys (utils/dtypes.py), so -0.0 sorts below +0.0 and NaNs follow their
bits, exactly as in the radix path.
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch.utils import dtypes as _dt


def sort_select(x: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) of ``x`` by a full sort, on ``x``'s
    device. ``k`` is clamped to [1, n]; it may also be a list or tensor of
    ranks (one sort, then one gather), and the answer takes its shape."""
    x = x.reshape(-1)
    bits = _dt.key_bits(x.dtype)
    keys = _dt.order_bias(_dt.to_sortable_bits(x), bits)
    s = _dt.order_bias(torch.sort(keys).values, bits)
    idx = torch.as_tensor(k, dtype=torch.int64, device=x.device).clamp(1, x.numel()) - 1
    return _dt.from_sortable_bits(s[idx], x.dtype)
