"""The batched top-k values kernel: wrapper, plain version and counters.

Counterpart of ``mpi_k_selection_tpu/ops/pallas/topk.py``.
:func:`batched_topk_values` returns the k largest elements of every row of
a ``(B, D)`` float32 or bfloat16 tensor, sorted descending in the sortable
keys' order (utils/dtypes.py), bit for bit the input's own elements. It is
a CUDA kernel (``csrc/topk.cu``) behind a wrapper, and it replaces
``pallas_batched_topk_values``. :func:`batched_topk_supported` is the JAX
package's envelope for that kernel.

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it computes the same function with plain tensor ops
(:func:`batched_topk_values_plain`). ``LAUNCHES`` counts kernel launches
and ``PLAIN_CALLS`` the plain version's calls.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_k_selection_tpu_torch.ops.cuda.histogram import resolve_hist_method
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

LAUNCHES = {"batched_topk_values32": 0, "batched_topk_values16": 0}
PLAIN_CALLS = {"batched_topk_values": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for name in d:
            d[name] = 0


def batched_topk_supported(shape, dtype, k) -> bool:
    """Whether :func:`batched_topk_values` takes a ``shape`` input of
    ``dtype`` for this k: 2-D, float32 or bfloat16, 1 <= k <= 16, B a
    multiple of 64, D a multiple of 1024 and at least 4096 (the JAX
    package's ``batched_topk_supported``)."""
    if len(shape) != 2:
        return False
    try:
        if _dt.torch_dtype(dtype) not in _DTYPES:
            return False
    except TypeError:  # not a selection dtype at all
        return False
    b, d = shape
    return 1 <= k <= 16 and b % 64 == 0 and d % 1024 == 0 and d >= 4096


def batched_topk_values_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_topk_values`: a stable
    descending sort of the signed keys of each row, the first k decoded
    back to values bit for bit."""
    bits = _dt.key_bits(x.dtype)
    keys = _dt.order_bias(_dt.to_sortable_bits(x), bits)
    kv = torch.sort(keys, dim=-1, descending=True, stable=True).values[:, :k]
    return _dt.from_sortable_bits(_dt.order_bias(kv, bits), x.dtype)


def _lib():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    lib = build.load("topk")
    if not getattr(lib, "_ksel_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for bits in (32, 16):
            f = getattr(lib, f"ksel_batched_topk{bits}")
            f.argtypes = [p, ll, i, i, p, p]
            f.restype = i
        lib.ksel_error_string.argtypes = [i]
        lib.ksel_error_string.restype = ctypes.c_char_p
        lib._ksel_typed = True
    return lib


def batched_topk_values(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, k)`` tensor of ``x``'s dtype: the k largest elements of each
    row of the contiguous ``(B, D)`` tensor ``x``, sorted descending (keys'
    order: ``-0.0 < +0.0``, NaNs ordered by sign). ``x``'s shape, dtype and
    k must lie in :func:`batched_topk_supported`."""
    if not batched_topk_supported(tuple(x.shape), x.dtype, k):
        raise ValueError(f"unsupported batched-topk shape {tuple(x.shape)} dtype {x.dtype} k={k}")
    if resolve_hist_method(x.device) == "plain":
        PLAIN_CALLS["batched_topk_values"] += 1
        return batched_topk_values_plain(x, k)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    bits = 8 * x.element_size()
    b, d = x.shape
    out = torch.empty((b, k), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"ksel_batched_topk{bits}")(
            x.data_ptr(), b, d, k, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream
        )
    if rc != 0:
        raise RuntimeError(f"batched_topk_values{bits} launch failed: {lib.ksel_error_string(rc).decode()}")
    LAUNCHES[f"batched_topk_values{bits}"] += 1
    return out
