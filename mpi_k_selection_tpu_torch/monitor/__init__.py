"""Continuous quantiles over unbounded streams: sliding-window and
decayed sketches (counterpart of ``mpi_k_selection_tpu/monitor``).

- ``windows.py``: :class:`WindowedSketch`, a ring of per-time-bucket
  RadixSketches whose two-stack aggregation advances in O(1) amortized
  merges, the same bits as a from-scratch merge of the live buckets.
- ``decay.py``: :class:`DecayedWindowedSketch` / :class:`DecayedSketch`,
  the exponential decay with integer fixed-point weights, so decayed
  merges stay exact.
- ``monitor.py``: :class:`Monitor`, which drives a chunk source (one-shot
  included) through the streamed staging and the sweep kernel's sketch
  part and yields a p50/p90/p99 sample stream, and
  :func:`start_metrics_server`, the Prometheus text exposition of its
  registry on a port (the CLI's ``monitor --prometheus-port``).
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.monitor.decay import DECAY_SHIFT, DecayedSketch, DecayedWindowedSketch, decay_weight
from mpi_k_selection_tpu_torch.monitor.monitor import (
    MetricsHTTPServer,
    Monitor,
    MonitorSample,
    q_label,
    start_metrics_server,
)
from mpi_k_selection_tpu_torch.monitor.windows import WindowedSketch

__all__ = [
    "DECAY_SHIFT",
    "DecayedSketch",
    "DecayedWindowedSketch",
    "MetricsHTTPServer",
    "Monitor",
    "MonitorSample",
    "WindowedSketch",
    "decay_weight",
    "q_label",
    "start_metrics_server",
]
