"""Order-preserving bit transforms for radix selection (PyTorch).

Counterpart of ``mpi_k_selection_tpu/utils/dtypes.py``. Radix select works
on unsigned keys whose numeric order equals the order of the original
values; this module maps every supported dtype to such keys and back.

Transform rules (the same as the JAX package's):

- signed int  -> flip the sign bit: ``u = bits(x) ^ MSB``
- unsigned    -> identity
- float       -> if the sign bit is set, flip all bits; else set the sign
  bit. This orders -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN (NaNs with
  the sign bit clear sort last like NumPy; negative-NaN bit patterns sort
  first — documented deviation).

Carrier dtypes. PyTorch's unsigned dtypes have almost no arithmetic (no
``>>``, ``<``, ``bincount`` on the CPU build), so keys are carried as
SIGNED integer bit patterns: ``int32`` for keys of up to 32 bits and
``int64`` for 64-bit keys. Sub-32-bit keys are widened to non-negative
``int32`` values, so signed order equals key order for them; 32- and
64-bit keys compare in biased signed order (``key ^ MSB``) wherever order
matters (:func:`order_bias`).
"""

from __future__ import annotations

import numpy as np
import torch

# torch dtype -> total key bits
_KEY_BITS = {
    torch.int8: 8,
    torch.uint8: 8,
    torch.int16: 16,
    torch.uint16: 16,
    torch.int32: 32,
    torch.uint32: 32,
    torch.int64: 64,
    torch.uint64: 64,
    torch.float16: 16,
    torch.bfloat16: 16,
    torch.float32: 32,
    torch.float64: 64,
}

# same-width signed integer dtype for each key width (the bit-pattern view)
_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}
_NP_UNSIGNED = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_SIGNED_INT = (torch.int8, torch.int16, torch.int32, torch.int64)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for ``dtype`` (a torch dtype, a numpy dtype, a
    dtype name, or ml_dtypes' ``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or dt not in _KEY_BITS:
        raise TypeError(f"unsupported dtype for k-selection: {dtype}")
    return dt


def key_bits(dtype) -> int:
    """Total number of key bits for ``dtype``."""
    return _KEY_BITS[torch_dtype(dtype)]


def key_dtype(dtype) -> torch.dtype:
    """Carrier dtype of the keys for ``dtype``: int32 up to 32 key bits,
    int64 for 64 (the JAX package returns the unsigned key dtype)."""
    return torch.int64 if key_bits(dtype) == 64 else torch.int32


def key_fold(dtype):
    """In-kernel form of :func:`to_sortable_bits` for raw-bits kernel input:
    ``("xor", C)`` when ``key == raw ^ C`` (every 32/64-bit integer dtype:
    C is the sign-bit mask for signed, 0 for unsigned), ``("float",)`` for
    float32/float64, None for sub-32-bit dtypes (widened to 32-bit keys
    before the kernels, which subsumes the transform)."""
    dt = torch_dtype(dtype)
    bits = _KEY_BITS[dt]
    if bits < 32:
        return None
    if dt in _UNSIGNED:
        return ("xor", 0)
    if dt in _SIGNED_INT:
        return ("xor", 1 << (bits - 1))
    return ("float",)


def signed_const(v: int, bits: int) -> int:
    """Python int holding the ``bits``-wide unsigned pattern ``v`` as the
    signed value of the same bits (what a signed tensor of that width
    stores)."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def shift_right_logical(x: torch.Tensor, s: int, bits: int) -> torch.Tensor:
    """Logical right shift of ``bits``-wide patterns held in a signed
    tensor of that width: an arithmetic shift, then the sign copies
    masked off."""
    if s == 0:
        return x
    if s >= bits:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (bits - s)) - 1)


def order_bias(keys: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Map carrier keys to a tensor whose SIGNED order is the keys'
    unsigned order (an involution: apply twice to get the keys back).
    Sub-32-bit keys are non-negative already."""
    if total_bits < 32:
        return keys
    return keys ^ torch.iinfo(keys.dtype).min


def max_key(total_bits: int) -> int:
    """The order-maximum key in its carrier's value."""
    return (1 << total_bits) - 1 if total_bits < 32 else -1


def keys_from_raw(w: torch.Tensor, key_op: str, key_xor: int = 0) -> torch.Tensor:
    """Carrier keys of raw 32/64-bit words ``w`` (an int32/int64 view)
    under a :func:`key_fold` transform: ``"none"`` (already keys),
    ``"xor"`` with ``key_xor``, or ``"float"``."""
    bits = w.element_size() * 8
    if key_op == "xor":
        return w ^ signed_const(key_xor, bits)
    if key_op == "float":
        return w ^ ((w >> (bits - 1)) | signed_const(1 << (bits - 1), bits))
    return w


def bit_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the signed integer dtype of its width (no copy):
    the form in which every dtype can be indexed and compared on CUDA."""
    return x.view(_SIGNED[_KEY_BITS[x.dtype]])


def to_sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """Keys of ``x`` in its carrier dtype (:func:`key_dtype`), same shape
    and device."""
    dt = torch_dtype(x.dtype)
    bits = _KEY_BITS[dt]
    u = bit_view(x)
    if dt in _SIGNED_INT:
        u = u ^ signed_const(1 << (bits - 1), bits)
    elif dt not in _UNSIGNED:
        # float: negative -> all bits flipped, else sign bit set; the
        # arithmetic shift spreads the sign into the xor mask
        u = u ^ ((u >> (bits - 1)) | signed_const(1 << (bits - 1), bits))
    if bits < 32:
        return u.to(torch.int32) & ((1 << bits) - 1)
    return u


def from_sortable_bits(u: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`to_sortable_bits`: carrier keys -> ``dtype``."""
    dt = torch_dtype(dtype)
    bits = _KEY_BITS[dt]
    s = u.to(_SIGNED[bits])  # narrowing keeps the low bits
    if dt in _UNSIGNED:
        return s.view(dt)
    msb = signed_const(1 << (bits - 1), bits)
    if dt in _SIGNED_INT:
        return (s ^ msb).view(dt)
    # keys with the sign bit clear came from negative floats: flip all
    return (s ^ ((~s >> (bits - 1)) | msb)).view(dt)


def np_to_sortable_bits(x: np.ndarray) -> np.ndarray:
    """Host (NumPy) twin: unsigned keys (uint8/16/32/64) of ``x``, the same
    values the JAX package's ``np_to_sortable_bits`` returns."""
    x = np.ascontiguousarray(x)
    bits = key_bits(x.dtype)
    kdt = np.dtype(_NP_UNSIGNED[bits])
    u = x.view(kdt)
    dt = torch_dtype(x.dtype)
    if dt in _UNSIGNED:
        return u
    msb = kdt.type(1 << (bits - 1))
    if dt in _SIGNED_INT:
        return u ^ msb
    all_ones = kdt.type((1 << bits) - 1)
    neg = (u >> kdt.type(bits - 1)) != kdt.type(0)
    return np.where(neg, u ^ all_ones, u | msb)


def np_from_sortable_bits(u: np.ndarray, dtype) -> np.ndarray:
    """Inverse of :func:`np_to_sortable_bits`; ``dtype`` is a numpy dtype
    (ml_dtypes' ``bfloat16`` for bfloat16)."""
    dtype = np.dtype(dtype)
    bits = key_bits(dtype)
    kdt = np.dtype(_NP_UNSIGNED[bits])
    u = np.ascontiguousarray(np.asarray(u, kdt))
    dt = torch_dtype(dtype)
    if dt in _UNSIGNED:
        return u.view(dtype)
    msb = kdt.type(1 << (bits - 1))
    if dt in _SIGNED_INT:
        return (u ^ msb).view(dtype)
    all_ones = kdt.type((1 << bits) - 1)
    raw = np.where((u & msb) == kdt.type(0), u ^ all_ones, u & ~msb)
    return np.ascontiguousarray(raw).view(dtype)
