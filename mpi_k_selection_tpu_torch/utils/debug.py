"""Input and result checks (counterpart of ``mpi_k_selection_tpu/utils/debug.py``).

- :func:`check_concrete_k` — the k-range contract every entry point shares.
- :func:`check_concrete_ks` — its form for many ranks.
- :func:`rank_certificate` — ``(#less, #less-or-equal)`` around an answer:
  the value has rank k exactly when ``less < k <= leq``, the reference's
  exact-hit test (``TODO-kth-problem-cgm.c:194``) applied as a
  post-condition.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.utils import dtypes as _dt


def check_concrete_k(k, n: int) -> None:
    """Raise ValueError when a host k is outside [1, n] (k is 1-indexed).

    A k that is a torch tensor passes through: it may live on the device,
    and reading it would sync; the ops clamp it to [1, n], as the JAX
    package clamps a traced k."""
    if isinstance(k, torch.Tensor):
        return
    try:
        kv = int(k)
    except (TypeError, ValueError):  # non-scalar / non-integer-like: not ours
        return
    if not 1 <= kv <= n:
        raise ValueError(f"k={kv} out of range [1, {n}] (k is 1-indexed)")


def check_concrete_ks(ks, n: int) -> None:
    """:func:`check_concrete_k` for every k of a host ``ks`` (a scalar, a
    list or an array, of any shape). A tensor ``ks`` passes through and is
    clamped in the ops; a ragged or non-numeric ``ks`` raises."""
    if isinstance(ks, torch.Tensor):
        return
    for k in np.asarray(ks).ravel():
        check_concrete_k(int(k), n)


def rank_certificate(x: torch.Tensor, value):
    """``(#elements < value, #elements <= value)`` in key order, as int64
    tensors on ``x``'s device."""
    x = x.reshape(-1)
    bits = _dt.key_bits(x.dtype)
    v = torch.as_tensor(value, dtype=x.dtype, device=x.device).reshape(1)
    u = _dt.order_bias(_dt.to_sortable_bits(x), bits)
    vk = _dt.order_bias(_dt.to_sortable_bits(v), bits)
    return (u < vk).sum(), (u <= vk).sum()
