"""The total order of the references: values as signed integer keys.

Integers are their own keys. A float's bit pattern, viewed as a signed
integer, keeps its order where the sign bit is clear and reverses it where it
is set; flipping every bit but the sign of the negative ones makes signed
order equal value order, with ``-0.0`` below ``+0.0``, ``+nan`` above
``+inf`` and ``-nan`` below ``-inf`` (the order the port documents for its
answers). The map is its own inverse. Written here from that definition,
not taken from the port.
"""

from __future__ import annotations

import torch

_FLOAT_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64,
               torch.float8_e4m3fn: torch.int8}
_LOW = {torch.int8: 0x7F, torch.int16: 0x7FFF, torch.int32: 0x7FFFFFFF, torch.int64: 0x7FFFFFFFFFFFFFFF}


def to_keys(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys whose order is ``x``'s total order."""
    bits = _FLOAT_BITS.get(x.dtype)
    if bits is None:
        return x
    b = x.view(bits)
    return torch.where(b < 0, b ^ _LOW[bits], b)


def from_keys(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``dtype`` whose keys are ``keys`` (the inverse of
    :func:`to_keys`)."""
    bits = _FLOAT_BITS.get(dtype)
    if bits is None:
        return keys.to(dtype)
    b = keys.to(bits)
    return torch.where(b < 0, b ^ _LOW[bits], b).view(dtype)


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bit patterns as integers, for an exact comparison."""
    bits = _FLOAT_BITS.get(x.dtype)
    return x if bits is None else x.view(bits)


def sorted_keys(x: torch.Tensor) -> torch.Tensor:
    """Every key of 1-D ``x`` in ascending order: a plain sort."""
    return torch.sort(to_keys(x)).values
