"""Exponentially decayed windowed quantiles with fixed-point count scaling,
so decayed merges stay exact, associative and commutative (counterpart of
``mpi_k_selection_tpu/monitor/decay.py``).

- A bucket of age ``a`` (advances before the current one) weighs
  ``decay_weight(decay, a) = round(decay^a * 2^DECAY_SHIFT)``, an integer
  on a ``2^DECAY_SHIFT`` scale.
- A decayed aggregate is ``sum_a bucket_a.counts * weight(a)``: every term
  an exact int64 product, so any grouping or order of the folds gives the
  same accumulator (``RadixSketch.fold_scaled``).
- ``decay=1.0`` weighs every age ``2^DECAY_SHIFT`` exactly: the undecayed
  aggregate with every count shifted left, so rank queries resolve the
  same bucket as the undecayed sketch's.

Width: scaled counts share the int64 pyramid, so a window's unweighted
count must stay below ``2^(63 - DECAY_SHIFT)`` (``fold_scaled`` refuses
past it). A bucket whose weight rounds to 0 adds nothing.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.monitor.windows import WindowedSketch
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch

#: Fixed-point scale of the weights: 20 bits leave 2^43 unweighted counts
#: of int64 headroom a window.
DECAY_SHIFT = 20


def decay_weight(decay: float, age: int, *, shift: int = DECAY_SHIFT) -> int:
    """Fixed-point weight of a bucket ``age`` advances old:
    ``round(decay^age * 2^shift)``; exactly ``2^shift`` for every age at
    ``decay=1.0``, 0 once the bucket has decayed out."""
    decay = float(decay)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    age = int(age)
    if age < 0:
        raise ValueError(f"bucket age must be >= 0, got {age}")
    return int(round(decay**age * (1 << shift)))


class DecayedSketch(RadixSketch):
    """A decay-weighted RadixSketch: counts on the ``2^shift`` fixed-point
    scale, ``n`` the total weighted count. Ranks given to ``query`` /
    ``rank_bounds`` / ``value_bounds`` / ``pin`` are weighted ranks in [1,
    n]; ``quantile(s)`` convert through nearest rank on ``n``. The bounds
    stay exact over weighted ranks."""

    def __init__(self, dtype, *, radix_bits: int = 4, levels: int = 4, decay: float = 1.0,
                 shift: int = DECAY_SHIFT, device=None):
        super().__init__(dtype, radix_bits=radix_bits, levels=levels, device=device)
        self.decay = float(decay)
        self.shift = int(shift)
        #: the fixed-point scale of a count at age 0
        self.scale = 1 << self.shift

    @property
    def weighted_n(self) -> int:
        return self.n

    def fold_bucket(self, bucket: RadixSketch, age: int) -> "DecayedSketch":
        """Fold one time bucket ``age`` advances old at its weight (a zero
        weight folds nothing). Returns ``self``."""
        self.fold_scaled(bucket, decay_weight(self.decay, age, shift=self.shift))
        return self


class DecayedWindowedSketch(WindowedSketch):
    """The exponentially decayed sliding window: the ring and O(1) advance
    of :class:`WindowedSketch` (ages are given at query time, the current
    bucket age 0), ``query`` a :class:`DecayedSketch` of the live buckets
    at their weights. Weights change every advance, so no aggregates are
    cached and a query folds its O(window) buckets."""

    _maintain_aggregates = False

    def __init__(self, dtype, *, window: int, decay: float, radix_bits: int = 4, levels: int = 4,
                 shift: int = DECAY_SHIFT, device=None):
        super().__init__(dtype, window=window, radix_bits=radix_bits, levels=levels, device=device)
        self.decay = float(decay)
        self.shift = int(shift)
        decay_weight(self.decay, 0, shift=self.shift)  # checks decay

    def query(self, window: int | None = None) -> DecayedSketch:
        """``sum_a bucket_a * weight(a)`` over the newest ``window`` live
        buckets, the same bits in any order or grouping."""
        w = self._resolve_window(window)
        out = DecayedSketch(self.dtype, radix_bits=self.radix_bits, levels=self.levels, decay=self.decay,
                            shift=self.shift, device=self.device)
        newest_first = list(reversed(self.live_buckets()))[:w]
        for age, bucket in enumerate(newest_first):
            out.fold_bucket(bucket, age)
        return out
