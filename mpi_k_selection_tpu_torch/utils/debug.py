"""Input and result checks (counterpart of ``mpi_k_selection_tpu/utils/debug.py``).

- :func:`check_concrete_k` — the k-range contract every entry point shares.
- :func:`check_concrete_ks` — its form for many ranks.
- :func:`validate_input` — host-side checks before a selection runs: an
  empty input, k out of range, NaNs that break the total order.
- :func:`rank_certificate` — ``(#less, #less-or-equal)`` around an answer:
  the value has rank k exactly when ``less < k <= leq``, the reference's
  exact-hit test (``TODO-kth-problem-cgm.c:194``) applied as a
  post-condition.
- :func:`checked_kselect` — selection plus that certificate.
- :func:`checkify_kselect` — the JAX package's in-kernel checks under
  ``checkify``; PyTorch runs eagerly, so here they are host checks that
  raise the same messages before the selection runs.
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


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

    return tensor_from_numpy(np.asarray(x), "cpu")


def validate_input(x, k: int, *, allow_nan: bool = False) -> None:
    """Raise ValueError on inputs that would make selection ill-defined."""
    x = _as_tensor(x)
    if x.numel() == 0:
        raise ValueError("selection requires a non-empty input")
    if not 1 <= int(k) <= x.numel():
        raise ValueError(f"k={k} out of range [1, {x.numel()}] (k is 1-indexed)")
    if not allow_nan and x.is_floating_point() and bool(torch.isnan(x).any()):
        raise ValueError(
            "input contains NaN: NaNs break total ordering; pass "
            "allow_nan=True to rank them with the IEEE-bits order "
            "(utils/dtypes.py) instead"
        )


def checked_kselect(x, k: int, **kwargs):
    """kselect + rank certificate. Raises AssertionError if the returned
    value is not the exact k-th order statistic."""
    from mpi_k_selection_tpu_torch import api

    validate_input(x, k, allow_nan=kwargs.pop("allow_nan", False))
    x = api.as_selection_array(x, kwargs.pop("device", None))
    value = api.kselect(x, k, **kwargs)
    less, leq = (int(c) for c in rank_certificate(x, value))
    if not less < k <= leq:
        raise AssertionError(
            f"selection certificate failed: value {value} has rank range "
            f"({less}, {leq}] but k={k} — please report this"
        )
    return value


def checkify_kselect(x, k, **kwargs):
    """Selection after the JAX package's ``checkify`` checks, run on the
    host: ValueError("k must be >= 1, got {k}") or ("k must be <= n={n},
    got {k}"), the messages its ``error.throw()`` carries; else the
    answer."""
    from mpi_k_selection_tpu_torch import api

    x = api.as_selection_array(x, kwargs.pop("device", None))
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > x.numel():
        raise ValueError(f"k must be <= n={x.numel()}, got {k}")
    return api.kselect(x, k, **kwargs)
