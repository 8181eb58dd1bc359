"""The traced window's records, counted before they are divided.

The traced run wraps its window in ``torch.profiler`` and marks it with the
user annotation ``WINDOW``. This module reads the exported Chrome trace into
plain events and gives the per-layer readers what they divide: the device's
busy time (the union of its kernel, copy and set intervals), kernels by name
pattern, device-to-host copies, and the launches the port's own books
counted over the same window.

A profiler can drop device records. So a kernel group is only measured when
the trace holds exactly as many of its kernels as the port's launch books
(``LAUNCHES`` in ``mpi_k_selection_tpu_torch.ops.cuda``, program counters)
say the traced queries made; otherwise :class:`CountMismatch` is raised and
the reader reports nothing. A roofline share above 100% means the bytes are
counted too high or the time misses work: :func:`checked_share` raises
:class:`ShareOver100`, which fails the traced run.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field

WINDOW = "kbench.window"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation"})
TOP = 10  # entries of each breakdown list


class CountMismatch(RuntimeError):
    """The trace and the launch books disagree on a kernel group's count."""


class ShareOver100(RuntimeError):
    """A roofline share read above 100%."""


@dataclass(frozen=True)
class Event:
    cat: str
    name: str
    ts: float  # microseconds
    dur: float  # microseconds

    @property
    def end(self) -> float:
        return self.ts + self.dur


def load_chrome(path) -> list[Event]:
    """The complete ("X") events of a Chrome trace file that
    ``torch.profiler`` exported."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [Event(e.get("cat", ""), e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in evs if e.get("ph") == "X" and "ts" in e]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class View:
    """The traced window: its events, the queries it held and the launch
    books' counts over it, and what the readers need of the cell."""

    events: list[Event]
    queries: int
    books: dict = field(default_factory=dict)  # launch-book name -> launches in the window
    kind: str = ""  # torch.cuda.get_device_name()
    config: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    least_bytes: int = 0  # the least bytes one query needs (the op module's count)

    def __post_init__(self):
        marks = [e for e in self.events if e.name == WINDOW and e.cat == "user_annotation"]
        if len(marks) != 1:
            raise ValueError(f"the trace holds {len(marks)} '{WINDOW}' marks, not one")
        self.t0, self.t1 = marks[0].ts, marks[0].end
        self.device = [e for e in self.events if e.cat in DEVICE_CATS and self.t0 <= e.ts < self.t1]
        self.host = sorted((e for e in self.events if e.cat in HOST_CATS and e.name != WINDOW),
                           key=lambda e: e.ts)
        self._starts = [e.ts for e in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return merge((e.ts, min(e.end, self.t1)) for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self, patterns) -> list[Event]:
        rx = [re.compile(p) for p in patterns]
        return [e for e in self.device if e.cat == "kernel" and any(r.search(e.name) for r in rx)]

    def launches(self, books) -> int:
        return sum(int(self.books.get(b, 0)) for b in books)

    def group(self, patterns, books) -> tuple[int, float]:
        """``(launches, device seconds)`` of the kernels matching
        ``patterns``, once their count in the trace equals the launches that
        the ``books`` recorded; :class:`CountMismatch` otherwise."""
        ks = self.kernels(patterns)
        want = self.launches(books)
        if len(ks) != want:
            raise CountMismatch(f"{patterns}: {len(ks)} kernels in the trace, {want} launches in {list(books)}")
        return want, sum(e.dur for e in ks) / 1e6

    def dtoh_copies(self) -> list[Event]:
        return [e for e in self.device if e.cat == "gpu_memcpy" and "DtoH" in e.name]

    def host_op_at(self, t: float) -> str:
        """The innermost host op running at ``t`` (the latest started that
        has not ended), or ``"host: no recorded op"``."""
        i = bisect.bisect_right(self._starts, t)
        for e in reversed(self.host[max(0, i - 64):i]):
            if e.end >= t:
                return e.name
        return "host: no recorded op"

    def breakdown(self) -> dict:
        """The device ops that took most time and the longest idle gaps,
        summed by what the host was doing in them: ``[name, seconds]``
        lists of at most ``TOP`` entries."""
        ops: dict[str, float] = {}
        for e in self.device:
            ops[e.name[:120]] = ops.get(e.name[:120], 0.0) + e.dur / 1e6
        gaps: dict[str, float] = {}
        prev = self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                name = self.host_op_at((prev + s) / 2)[:120]
                gaps[name] = gaps.get(name, 0.0) + (s - prev) / 1e6
            prev = max(prev, e)
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def _top(seconds_by_name: dict) -> list:
    return [[k, v] for k, v in sorted(seconds_by_name.items(), key=lambda kv: -kv[1])[:TOP]]


def checked_share(pct: float | None, what: str) -> float | None:
    """``pct`` as read, or :class:`ShareOver100` when it passes 100%."""
    if pct is not None and pct > 100.0:
        raise ShareOver100(f"{what} reads {pct:.4f}% of its roofline: bytes counted too high or time missed")
    return pct
