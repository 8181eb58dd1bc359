"""DeviceVector — the port's counterpart of the reference's L1 layer.

The reference's only data structure is the ``IntVector`` growable int
array (``vector.h:7-11``: ``{int size; int capacity; int *data}``) with an
ADT API (``vector.h:13-34``); ``mpi_k_selection_tpu/buffer.py`` carries it
as ``(data[capacity], size)`` with every operation masking on ``iota <
size``. PyTorch runs eagerly, so here ``size`` is a host int and
``data`` a tensor on an explicit device; elements past ``size`` are dead
storage, like the C struct's unused capacity.

API correspondence (reference ``file:line`` -> here):

=====================================  =====================================
``VecNew``            vector.c:53-70   ``DeviceVector.new`` / ``from_array``
``VecAdd``            vector.c:73-91   ``add`` (grows x2 when full, the
                                       realloc of ``:79-84``)
``VecDelete``         vector.c:96-105  garbage collection (no-op needed)
``VecErase``          vector.c:108-121 ``erase`` — faithful O(1)
                                       swap-with-last, order-destroying
``MinFind``/``MaxFind`` vector.c:123-159 ``min``/``max`` (masked reductions)
``AverageFind``       vector.c:162-171 ``sum`` — the reference function is
                                       misnamed and returns the sum;
                                       ``mean`` is the repaired version
``VecGetCapacity`` …  vector.c:175-192 ``capacity``, ``size``, ``is_full``
``VecSet``/``VecGet`` vector.c:194-218 ``set``/``get`` (bounds-checked)
``VecSearch``         vector.c:220-235 ``search`` (a masked first match)
``VecQuickSort(2)``   vector.c:23-50,  ``sort`` (one ``torch.sort`` of the
                      :239-241         keys, dead slots keyed to the
                                       order-maximum)
``VecBinarySearch(2)`` vector.c:249-287 ``binary_search`` (searchsorted)
``compact``           (repair)         ordered masked compaction — what the
                                       CGM discard phase should have used
                                       instead of ``VecErase``
=====================================  =====================================

Immutable: every mutator returns a new DeviceVector, as the JAX package's
does, so the two agree operation by operation.
"""

from __future__ import annotations

import dataclasses

import torch

from mpi_k_selection_tpu_torch.utils import dtypes as _dt


@dataclasses.dataclass(frozen=True)
class DeviceVector:
    """Fixed-capacity device array with a logical size."""

    data: torch.Tensor
    size: int  # 0 <= size <= capacity

    # -- constructors (VecNew, vector.c:53-70) ---------------------------
    @classmethod
    def new(cls, capacity: int, dtype=torch.int32, device="cuda") -> DeviceVector:
        return cls(torch.zeros(capacity, dtype=dtype, device=device), 0)

    @classmethod
    def from_array(cls, x, device=None) -> DeviceVector:
        from mpi_k_selection_tpu_torch.api import as_selection_array

        x = as_selection_array(x, device).reshape(-1)
        return cls(x, x.numel())

    # -- accessors (vector.c:175-192) ------------------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_full(self) -> bool:
        return self.size >= self.capacity

    def _mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.size

    def to_array(self) -> torch.Tensor:
        """The live prefix."""
        return self.data[: self.size]

    def _value(self, value) -> torch.Tensor:
        return torch.as_tensor(value, device=self.device).to(self.data.dtype)

    # -- append (VecAdd, vector.c:73-91) ---------------------------------
    def add(self, value) -> DeviceVector:
        data = self.data
        if self.size >= self.capacity:  # realloc x2 (vector.c:79-84)
            data = torch.cat([data, torch.zeros(max(1, self.capacity), dtype=data.dtype, device=self.device)])
        data = data.clone()
        data[self.size] = self._value(value)
        return DeviceVector(data, self.size + 1)

    # -- erase (VecErase, vector.c:108-121) ------------------------------
    def erase(self, pos: int) -> DeviceVector:
        """Faithful O(1) swap-with-last delete — destroys element order,
        exactly like the reference (its CGM discard sweeps,
        TODO-kth-problem-cgm.c:208/219). An out-of-range ``pos`` changes
        nothing."""
        if not 0 <= pos < self.size:
            return self
        data = self.data.clone()
        data[pos] = self.data[self.size - 1]
        return DeviceVector(data, self.size - 1)

    # -- ordered compaction (the repair of the discard phase) ------------
    def compact(self, keep_mask) -> DeviceVector:
        """Keep the live elements where ``keep_mask`` is True, in order:
        dead slots move to the tail, size shrinks."""
        keep = torch.as_tensor(keep_mask, dtype=torch.bool, device=self.device) & self._mask()
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        return DeviceVector(self.data[order], int(keep.sum()))

    # -- reductions (MinFind/MaxFind vector.c:123-159; AverageFind :162-171)
    def min(self) -> torch.Tensor:
        """Minimum of the live elements (MinFind); empty -> the dtype's
        order-maximum, a clean identity instead of the reference's -1."""
        big = _dt.from_sortable_bits(
            torch.full((), _dt.max_key(_dt.key_bits(self.data.dtype)), dtype=_dt.key_dtype(self.data.dtype),
                       device=self.device), self.data.dtype)
        return torch.where(self._mask(), self.data, big).min()

    def max(self) -> torch.Tensor:
        small = _dt.from_sortable_bits(
            torch.zeros((), dtype=_dt.key_dtype(self.data.dtype), device=self.device), self.data.dtype)
        return torch.where(self._mask(), self.data, small).max()

    def sum(self) -> torch.Tensor:
        """Sum of the live elements in the data's dtype — what the
        reference's ``AverageFind`` computes (it never divides)."""
        zero = torch.zeros((), dtype=self.data.dtype, device=self.device)
        return torch.where(self._mask(), self.data, zero).sum(dtype=self.data.dtype)

    def mean(self) -> torch.Tensor:
        """The repaired AverageFind: a real mean over the live elements."""
        return self.sum() / torch.tensor(float(max(self.size, 1)), dtype=torch.float32, device=self.device)

    # -- element access (VecSet/VecGet, vector.c:194-218) ----------------
    def get(self, i: int) -> torch.Tensor:
        """Bounds-checked read: out of range -> IndexError (the reference
        returns the -2 error code, conflating it with data)."""
        if not 0 <= i < self.size:
            raise IndexError(f"get({i}) out of range [0, {self.size})")
        return self.data[i]

    def set(self, i: int, value) -> DeviceVector:
        if not 0 <= i < self.size:
            raise IndexError(f"set({i}) out of range [0, {self.size})")
        data = self.data.clone()
        data[i] = self._value(value)
        return DeviceVector(data, self.size)

    # -- search (VecSearch vector.c:220-235) -----------------------------
    def search(self, element, start_pos: int = 0) -> int:
        """Index of the first live occurrence of ``element`` at or after
        ``start_pos`` (by ``==``: a NaN is never found, -0.0 finds +0.0);
        -1 when absent."""
        idx = torch.arange(self.capacity, device=self.device)
        v = self._value(element)
        eq = self.data == v if self.data.is_floating_point() else _dt.bit_view(self.data) == _dt.bit_view(v)
        hit = eq & self._mask() & (idx >= start_pos)
        return int(hit.to(torch.int32).argmax()) if bool(hit.any()) else -1

    def _keys(self) -> torch.Tensor:
        """Sortable keys biased into signed order, dead slots at the
        order-maximum."""
        bits = _dt.key_bits(self.data.dtype)
        keys = _dt.order_bias(_dt.to_sortable_bits(self.data), bits)
        top = _dt.order_bias(torch.tensor(_dt.max_key(bits), dtype=keys.dtype), bits).item()
        return torch.where(self._mask(), keys, top)

    # -- sort (VecQuickSort vector.c:239-241 / VecQuickSort2 :23-50) -----
    def sort(self) -> DeviceVector:
        """Ascending sort of the live prefix in key order (-0.0 before
        +0.0, NaNs by sign at the ends), dead slots after it."""
        order = torch.sort(self._keys(), stable=True).indices
        return DeviceVector(_dt.bit_view(self.data)[order].view(self.data.dtype), self.size)

    # -- binary search (VecBinarySearch vector.c:249-258 / :261-287) -----
    def binary_search(self, element) -> int:
        """Index of ``element`` in a sorted live prefix; -1 when absent.
        (The reference's fallback to a linear scan on a miss, vector.c:286,
        is a quirk, not a capability.)"""
        keys = self._keys()
        bits = _dt.key_bits(self.data.dtype)
        e = _dt.order_bias(_dt.to_sortable_bits(self._value(element).reshape(1)), bits)
        pos = int(torch.searchsorted(keys, e)[0])
        found = pos < self.size and bool(keys[min(pos, self.capacity - 1)] == e[0])
        return pos if found else -1
