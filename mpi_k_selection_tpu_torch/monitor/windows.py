"""WindowedSketch: a sliding ring of per-time-bucket RadixSketches with
O(1) amortized window advance (counterpart of
``mpi_k_selection_tpu/monitor/windows.py``).

RadixSketch merges are elementwise int64 sums, associative and
commutative, so a sliding-window aggregate needs neither subtraction
(which the extremes would not allow) nor a full re-merge: the two-stack
queue applies as it is.

- The **back** half collects freshly closed buckets with one running
  aggregate (one in-place merge an advance).
- The **front** half holds older buckets with precomputed suffix
  aggregates (each entry: itself merged with every younger front
  bucket), so evicting the oldest is a pop.
- When the front empties, the back **flips** into it in one sweep:
  amortized one merge an advance.

A full-window ``query()`` is ``front_suffix + back_aggregate + current``,
two merges whatever the window; a narrower ``query(window=w)`` re-merges
the newest ``w`` buckets. Either way the answer is a plain RadixSketch,
bit for bit a from-scratch merge of the same live buckets, with the
sketch's exact bounds. Time is whatever the caller advances on (the
monitor: every ``emit_every`` chunks); the sketch reads no clock.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch, sketch_dtype


class WindowedSketch:
    """Sliding window of the last ``window`` time buckets (the open
    ``current`` bucket included), each a :class:`RadixSketch` of one
    dtype's stream counting on ``device`` (default ``"cuda"``).

    ``update``/``update_value`` fold into the current bucket; ``advance()``
    closes it (evicting the oldest once the ring is full) and opens a new
    one; ``query(window=w)`` is the merged sketch of the newest ``w`` live
    buckets (default: all)."""

    #: False in a subclass whose query cannot use cached aggregates (the
    #: decayed window): advance() then skips their upkeep.
    _maintain_aggregates = True

    def __init__(self, dtype, *, window: int, radix_bits: int = 4, levels: int = 4, device=None):
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1 bucket, got {window}")
        self.dtype = sketch_dtype(dtype)
        self.window = window
        self.radix_bits = int(radix_bits)
        self.levels = int(levels)
        self.device = device
        #: completed window advances (the current bucket's epoch)
        self.epoch = 0
        self.current = self._fresh()
        # _front: [(bucket, suffix aggregate)], index 0 the youngest front
        # bucket, the end the oldest (popped at eviction); _back: young
        # closed buckets, oldest first; _back_agg their running merge
        self._front: list[tuple[RadixSketch, RadixSketch]] = []
        self._back: list[RadixSketch] = []
        self._back_agg: RadixSketch | None = None

    def _fresh(self) -> RadixSketch:
        return RadixSketch(self.dtype, radix_bits=self.radix_bits, levels=self.levels, device=self.device)

    # -- accumulation ------------------------------------------------------

    def update(self, chunk) -> "WindowedSketch":
        """Fold one chunk into the current bucket (RadixSketch.update)."""
        self.current.update(chunk)
        return self

    def update_value(self, value) -> "WindowedSketch":
        """Fold one observation into the current bucket (host arithmetic)."""
        self.current.update_value(value)
        return self

    def advance(self) -> "WindowedSketch":
        """Close the current bucket and open a new one, evicting the oldest
        once more than ``window - 1`` closed buckets are live: O(1)
        amortized merges."""
        self._back.append(self.current)
        if self._maintain_aggregates:
            if self._back_agg is None:
                self._back_agg = self.current.copy()
            else:
                self._back_agg.fold_scaled(self.current, 1)
        while len(self._front) + len(self._back) > self.window - 1:
            self._evict_oldest()
        self.current = self._fresh()
        self.epoch += 1
        return self

    def _evict_oldest(self) -> None:
        if not self._front:
            # flip: the back becomes the front, suffix aggregates made in one
            # newest-to-oldest sweep
            agg = None
            for b in reversed(self._back):
                if self._maintain_aggregates:
                    agg = b.copy() if agg is None else agg.merge(b)
                self._front.append((b, agg))
            self._back = []
            self._back_agg = None
        if self._front:
            self._front.pop()

    # -- queries -----------------------------------------------------------

    @property
    def n_live(self) -> int:
        """Live buckets, the open current bucket included."""
        return len(self._front) + len(self._back) + 1

    def live_buckets(self) -> list[RadixSketch]:
        """The live buckets, oldest first (current last): what a
        from-scratch merge of :meth:`query` would fold."""
        oldest_first = [b for b, _ in reversed(self._front)]
        return oldest_first + list(self._back) + [self.current]

    def _resolve_window(self, window) -> int:
        if window is None:
            return self.n_live
        window = int(window)
        if not 1 <= window <= self.window:
            raise ValueError(f"query window must be in [1, {self.window}] buckets, got {window}")
        return min(window, self.n_live)

    def query(self, window: int | None = None) -> RadixSketch:
        """The merged sketch of the newest ``window`` live buckets (default
        all): a plain RadixSketch with its exact bounds. The full window
        costs O(1) merges (the cached aggregates), a narrower one O(window);
        the same bits as a from-scratch fold of those buckets in any
        order."""
        w = self._resolve_window(window)
        closed_needed = w - 1
        out = self.current.copy()
        if self._maintain_aggregates and closed_needed >= len(self._front) + len(self._back):
            if self._back_agg is not None:
                out.fold_scaled(self._back_agg, 1)
            if self._front:
                out.fold_scaled(self._front[-1][1], 1)
            return out
        take_back = min(closed_needed, len(self._back))
        for b in self._back[len(self._back) - take_back:]:
            out.fold_scaled(b, 1)
        for b, _ in self._front[: closed_needed - take_back]:
            out.fold_scaled(b, 1)
        return out

    def quantiles(self, qs, window: int | None = None):
        """Nearest-rank quantile values over the queried window."""
        return self.query(window).quantiles(qs)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"{type(self).__name__}(dtype={self.dtype}, window={self.window}, "
            f"epoch={self.epoch}, n_live={self.n_live})"
        )
