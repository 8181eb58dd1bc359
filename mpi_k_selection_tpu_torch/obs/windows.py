"""Windowed histograms: a metrics-registry Histogram that also feeds a
sliding-window (optionally decayed) RadixSketch (counterpart of
``mpi_k_selection_tpu/obs/windows.py``).

A fixed-bucket Prometheus histogram answers "p99" by interpolating inside
the bucket the rank lands in. A :class:`WindowedHistogram` keeps that
contract (buckets, sum, count) and also folds every observation into a
:class:`~mpi_k_selection_tpu_torch.monitor.windows.WindowedSketch` over
``float64`` observations, advancing every ``advance_every``
observations (counts, never clocks), so the exposition gains quantiles
with exact rank and value bounds. Enable it per metric name before the
first observation::

    registry.enable_windowed("some.latency_seconds", window=8, advance_every=256)

The extra series are gauges named ``<name>_windowed`` (with a ``quantile``
label), ``<name>_windowed_rank_error`` and ``<name>_windowed_count``. The
folds are host arithmetic on the sketch's pyramid
(``RadixSketch.update_value``): no kernel runs.
"""

from __future__ import annotations

import math

from mpi_k_selection_tpu_torch.obs.metrics import DEFAULT_BUCKETS, Histogram

#: Default quantile set of the windowed exposition series.
DEFAULT_WINDOW_QUANTILES = (0.5, 0.9, 0.99)


class WindowedHistogram(Histogram):
    """A registry Histogram whose observations ALSO feed a sliding
    window of RadixSketch buckets (``float64`` observation space).
    Created by the registry when :meth:`~mpi_k_selection_tpu_torch.obs.
    metrics.MetricsRegistry.enable_windowed` named this metric; never
    constructed directly."""

    type_name = "histogram"

    def __init__(
        self, name, labels, lock, buckets=DEFAULT_BUCKETS, *,
        window: int = 8, advance_every: int = 256, radix_bits: int = 4,
        levels: int = 4, decay: float | None = None,
        quantiles=DEFAULT_WINDOW_QUANTILES,
    ):
        super().__init__(name, labels, lock, buckets=buckets)
        import numpy as np

        from mpi_k_selection_tpu_torch.monitor.decay import DecayedWindowedSketch
        from mpi_k_selection_tpu_torch.monitor.windows import WindowedSketch

        if decay is None:
            self.window_sketch = WindowedSketch(
                np.float64, window=window, radix_bits=radix_bits,
                levels=levels, device="cpu",
            )
        else:
            self.window_sketch = DecayedWindowedSketch(
                np.float64, window=window, decay=decay,
                radix_bits=radix_bits, levels=levels, device="cpu",
            )
        self.advance_every = int(advance_every)
        if self.advance_every < 1:
            raise ValueError(
                f"advance_every must be >= 1 observation, got {advance_every}"
            )
        self.window_quantiles = tuple(float(q) for q in quantiles)
        self._since_advance = 0

    def _observe_locked(self, value) -> None:
        super()._observe_locked(value)
        self.window_sketch.update_value(float(value))
        self._since_advance += 1
        if self._since_advance >= self.advance_every:
            self.window_sketch.advance()
            self._since_advance = 0

    def windowed_snapshot(self):
        """``[{q, value, rank_bounds, value_bounds, rank_error}, ...]``
        over the live window plus the window's count — ``None`` while
        the window is empty. The quantile values carry the merged
        sketch's EXACT bounds (weighted-rank space when decayed)."""
        with self._lock:
            m = self.window_sketch.query()
            if m.n == 0:
                return None
            out = []
            for q in self.window_quantiles:
                k = max(1, min(m.n, math.ceil(q * m.n)))
                lo, hi = m.rank_bounds(k)
                vlo, vhi = m.value_bounds(k)
                out.append(
                    {
                        "q": q,
                        "value": float(m.query(k)),
                        "rank_bounds": (int(lo), int(hi)),
                        "value_bounds": (float(vlo), float(vhi)),
                        "rank_error": int(hi - lo),
                    }
                )
            return {"n": int(m.n), "quantiles": out}

    def as_dict(self) -> dict:
        out = super().as_dict()
        snap = self.windowed_snapshot()
        out["windowed"] = None if snap is None else {
            "n": snap["n"],
            "window": self.window_sketch.window,
            "quantiles": {
                str(e["q"]): {
                    "value": e["value"],
                    "rank_bounds": list(e["rank_bounds"]),
                    "value_bounds": list(e["value_bounds"]),
                    "rank_error": e["rank_error"],
                }
                for e in snap["quantiles"]
            },
        }
        return out
