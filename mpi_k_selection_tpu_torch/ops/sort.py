"""Sort-then-index selection — the small-input path and an on-device oracle.

The reference's sequential semantics (``kth-problem-seq.c:32-33``): sort
ascending and take element ``k-1``. The order is ``lax.sort``'s, as the
JAX package's sort path answers in it (``ops/sort.py:sort_select``, and
``jnp.sort`` in its batched and many-ranks sort legs): the IEEE order for
floats with ``-0.0`` and ``+0.0`` equal and every NaN equal and last, ties
kept in position order, and the element itself returned, so each zero and
NaN comes back with its own bits. The radix paths answer in the sortable
keys' total order instead (utils/dtypes.py), as the JAX package's do.
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch.utils import dtypes as _dt


def sort_order_keys(x: torch.Tensor) -> torch.Tensor:
    """Signed keys whose ascending order is ``lax.sort``'s order of ``x``:
    for floats the IEEE order, with ``-0.0`` and ``+0.0`` equal and every
    NaN equal and above ``+inf`` (a stable sort then keeps such ties in
    position order). This is not the sortable keys' total order of the
    radix paths and ``topk``."""
    bits = _dt.key_bits(x.dtype)
    u = _dt.to_sortable_bits(x)
    if x.dtype.is_floating_point:
        plus_zero = _dt.to_sortable_bits(torch.zeros((), dtype=x.dtype)).item()
        u = torch.where(x == 0, plus_zero, u)
        u = torch.where(torch.isnan(x), _dt.max_key(bits), u)
    return _dt.order_bias(u, bits)


def sort_select(x: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) of ``x`` by a full stable sort, on
    ``x``'s device. ``k`` is clamped to [1, n]; it may also be a list or
    tensor of ranks (one sort, then one gather), and the answer takes its
    shape."""
    x = x.reshape(-1)
    order = torch.sort(sort_order_keys(x), stable=True).indices
    idx = torch.as_tensor(k, dtype=torch.int64, device=x.device).clamp(1, x.numel()) - 1
    # through the signed view: CUDA has no index kernel for uint16/32/64
    return _dt.bit_view(x)[order[idx]].view(x.dtype)
