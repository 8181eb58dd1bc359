"""Timing and structured result records.

The only module of the port that reads a clock. On a CUDA device a time is
taken with CUDA events around the calls and ends in a
``torch.cuda.synchronize()``: PyTorch returns before the device finishes,
so a host clock without the synchronise would time the enqueue. On the
CPU the host clock is the device clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Callable

import torch


def time_fn(fn: Callable[[], Any], *, repeats: int = 1, warmup: int = 0, device="cuda"):
    """Best-of-``repeats`` seconds of one ``fn()`` call, and its last
    result. ``device`` says where ``fn`` runs its work."""
    result = None
    for _ in range(warmup):
        result = fn()
    cuda = torch.device(device).type == "cuda"
    best = float("inf")
    for _ in range(max(1, repeats)):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0.record()
            result = fn()
            t1.record()
            torch.cuda.synchronize()
            seconds = t0.elapsed_time(t1) / 1e3
        else:
            c0 = time.perf_counter()
            result = fn()
            seconds = time.perf_counter() - c0
        best = min(best, seconds)
    return best, result


def cuda_ms(fn: Callable[[], Any], *, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of one ``fn()`` on the current CUDA device over
    ``iters`` back-to-back calls between two events, after ``warmup``."""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


class Stopwatch:
    """Host seconds and count of the blocks timed with :meth:`timing`:
    for work that has ended when the block ends (a blocking collective
    on host tensors, a host copy). Blocks may run on several threads at
    once: each adds its own time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.seconds = 0.0
            self.count = 0

    @contextlib.contextmanager
    def timing(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds += dt
                self.count += 1


class Deadline:
    """A monotonic deadline at the instant ``t1`` (``time.monotonic``
    seconds). :meth:`after` reads the clock once, here, and everyone
    downstream asks :meth:`remaining` or :attr:`expired` instead of
    reading a clock themselves: the serving layer (serve/batcher.py)
    threads one per request, so a waiter times out and the dispatch
    thread drops an expired query without touching ``time``."""

    __slots__ = ("_t1",)

    def __init__(self, t1: float):
        self._t1 = float(t1)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        """The deadline ``seconds`` (> 0) from now."""
        s = float(seconds)
        if s <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {s}")
        return cls(time.monotonic() + s)

    def remaining(self) -> float:
        """Seconds left, 0.0 once expired."""
        return max(0.0, self._t1 - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self._t1


@dataclasses.dataclass
class ResultRecord:
    """One run's record, as the JAX package's CLI writes it."""

    answer: Any
    n: int
    k: int
    backend: str
    algorithm: str
    dtype: str
    seconds: float
    device: str = ""
    n_devices: int = 1  # devices the run used, ranks sharing a card counted once (the mpi backend: its processes)
    rounds: int | None = None  # CGM rounds, where CGM ran
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def elems_per_sec_per_chip(self) -> float:
        if self.seconds <= 0:
            return float("inf")
        return self.n / self.seconds / max(1, self.n_devices)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["elems_per_sec_per_chip"] = self.elems_per_sec_per_chip
        return json.dumps(d, default=str)

    def print_reference_style(self) -> None:
        # the reference's output contracts: the seq program's "Solution found
        # solution=%d \ntime: %f\n" (kth-problem-seq.c:37), the others'
        # "kth element=%d \ntime: %f\n" (TODO-kth-problem-cgm.c:280)
        if self.backend == "seq":
            print(f"Solution found solution={self.answer} \ntime: {self.seconds:f}")
        else:
            print(f"kth element={self.answer} \ntime: {self.seconds:f}")
