"""Phase timing, the device trace and memory snapshots
(counterpart of ``mpi_k_selection_tpu/utils/profiling.py``).

- :class:`PhaseTimer`: named per-phase wall times, thread-safe, so the
  pipelined streamed pass accumulates its producer thread's phases
  (``pipeline.produce`` / ``encode`` / ``stage`` / ``spill``) and its
  consumer's (``pipeline.stall``, ``descent.pass``, ...) into one timer at
  once. An optional ``recorder`` (obs/trace.py:``TraceRecorder``) gets
  every finished ``(name, t0, t1)`` phase on the thread that ran it: the
  one bridge from this module's clock to the Chrome trace export. Raw
  clocks live here and in utils/timing.py only. While ``torch.profiler``
  records, each phase is also a ``record_function`` range, so it lands in
  the profiler's trace (the CLI's ``--trace-dir``) on the kernels' clock.
- :func:`span`: the port's spans (``ksel.*``: the entry points, the
  descent's passes and host reads, the collect, the kernel launches). A
  span is a ``record_function`` range while the profiler records, and
  also a :class:`PhaseTimer` phase when a timer is given (:func:`phase`
  is the same under the JAX package's argument order). With neither it is
  one shared ``nullcontext``: one C call and no allocation, 0.4-0.8 us a
  ``with`` block on a server CPU core, where an unguarded
  ``record_function`` costs about 16 us with the profiler off.
- :func:`trace`: ``torch.profiler`` around a block, its Chrome trace
  written into ``log_dir``. Unlike the JAX package's, which does nothing
  when the profiler cannot start, it raises then.
- :func:`device_memory_stats`: the bytes in use and the limit of each card.

The CLI uses them for ``--profile``, ``--trace-dir`` and
``--trace-events``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_OFF = contextlib.nullcontext()  # the one context every span shares while nothing records
_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass
class PhaseTimer:
    """Accumulates named phase durations: ``with timer.phase('sort'): ...``

    ``recorder`` (optional) gets ``record(name, t0, t1)`` for every
    finished phase, called on the thread that ran it, so one timer shared
    by the pipeline's producer and consumer gives spans on the right
    thread tracks."""

    phases: dict = field(default_factory=dict)  # ksel: guarded-by[_lock]
    counts: dict = field(default_factory=dict)  # ksel: guarded-by[_lock]
    recorder: object = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    @contextlib.contextmanager
    def phase(self, name: str, args: dict | None = None):
        """``args`` (optional) is span context handed to the recorder; it
        never enters the accumulated times. A recorder gets the 3-argument
        call when no args were given. While the profiler records, the
        phase is also a ``record_function`` range of the same name."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.phases[name] = self.phases.get(name, 0.0) + (t1 - t0)
                self.counts[name] = self.counts.get(name, 0) + 1
            if self.recorder is not None:
                if args is None:
                    self.recorder.record(name, t0, t1)
                else:
                    self.recorder.record(name, t0, t1, args)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    @property
    def total(self) -> float:
        with self._lock:
            return sum(self.phases.values())

    def as_dict(self) -> dict:
        with self._lock:
            return {name: {"seconds": s, "calls": self.counts[name]} for name, s in self.phases.items()}

    def report(self) -> str:
        with self._lock:  # one snapshot: a producer phase landing mid-report would tear it
            phases = dict(self.phases)
            counts = dict(self.counts)
        total = sum(phases.values()) or 1.0
        lines = ["phase timing:"]
        for name, s in sorted(phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<24} {s * 1e3:10.3f} ms  {100 * s / total:5.1f}%  ({counts[name]}x)")
        lines.append(f"  {'total':<24} {total * 1e3:10.3f} ms")
        return "\n".join(lines)


def phase(timer, name: str):
    """:func:`span` under the JAX package's name and argument order."""
    return span(name, timer)


def span(name: str, timer=None):
    """A span named ``name`` around a block: a ``record_function`` range
    while ``torch.profiler`` records (a ``user_annotation`` in its trace,
    and a ``gpu_user_annotation`` over the kernels the block launched),
    and ``timer.phase(name)`` when a :class:`PhaseTimer` is given. With
    the profiler off and no timer it returns one shared null context, so
    a span on a hot path costs one C call. It reads no clock itself and
    never touches the device."""
    if timer is not None:
        return timer.phase(name)
    return torch.profiler.record_function(name) if _profiler_enabled() else _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the host and, when a card is
    present, its kernels and copies); the Chrome trace goes to
    ``log_dir/trace-<pid>.json`` (open it in https://ui.perfetto.dev).
    Raises when the profiler cannot start."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


def device_memory_stats() -> list[dict]:
    """Each card's bytes in use (PyTorch's allocator) and its memory size;
    an empty list without a card."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
